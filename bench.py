"""Benchmark: graph-attention aggregate (SDDMM + masked softmax + SpMM),
forward AND backward — the cost training actually pays.

Prints ONE JSON line: {"metric": ..., "value": ..., "unit": "edges/s",
"vs_baseline": ..., "device": {...}}.

- value: real-edge throughput (edges × heads per second) of the chosen
  backend on the HAN workload (P meta-paths × K heads), one forward +
  backward (value_and_grad wrt features and both logit terms).
- vs_baseline: speedup over the dense masked-softmax path — a direct port
  of the reference's dense attention math (utils/layers.py:26-34) to XLA
  on the same device, also fwd+bwd. >1.0 beats the ported reference.

Runs on a GPU only: it exits non-zero when JAX finds none.

Usage: python bench.py [--impl csr|ell|dense] [--n N] [--heads K]
                       [--fwd-only] [--no-dense]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def median_time(fn, *args, warmup: int = 2, reps: int = 20) -> float:
    """Median wall time of ``fn(*args)``, each call waited on with
    ``block_until_ready``; the warmup calls absorb compilation."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--avg-degree", type=float, default=128.0)
    p.add_argument("--metapaths", type=int, default=2)
    p.add_argument("--impl", default="csr", choices=["csr", "ell", "dense"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--fwd-only", action="store_true")
    p.add_argument("--no-dense", action="store_true",
                   help="skip the dense baseline (O(N^2) memory); "
                        "vs_baseline is null")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="feature dtype fed to the backends (accumulators "
                        "stay f32)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from han_jax.utils.cache import setup_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    setup_compile_cache()

    from han_jax.graph.build import metapath_to_csr, metapath_to_dense
    from han_jax.graph.containers import ell_from_csr
    from han_jax.graph.synthetic import planted_hetero
    from han_jax.ops.attention import attention_aggregate

    ds = planted_hetero(
        n_nodes=args.n, n_feats=64, n_classes=3, n_metapaths=args.metapaths,
        avg_degree=args.avg_degree, train_per_class=100, n_val=100, seed=0)
    csr_graphs = [metapath_to_csr(a) for a in ds.metapath_adjs]
    total_edges = sum(g.n_edges for g in csr_graphs)

    rng = np.random.default_rng(0)
    k, d = args.heads, args.dim
    fdt = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    fts = jnp.asarray(rng.standard_normal((args.n, k, d)).astype(np.float32),
                      dtype=fdt)
    ld = jnp.asarray(rng.standard_normal((args.n, k)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((args.n, k)).astype(np.float32))

    def graphs_for(impl):
        if impl == "dense":
            return [metapath_to_dense(a) for a in ds.metapath_adjs]
        if impl == "ell":
            return [ell_from_csr(g) for g in csr_graphs]
        return csr_graphs

    def make_step(impl, fwd_only):
        def loss(f, a, b, graphs):
            return sum(attention_aggregate(g, f, a, b, impl=impl).sum()
                       for g in graphs)

        step = (jax.jit(loss) if fwd_only else
                jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2))))
        graphs = graphs_for(impl)
        return lambda f, a, b: step(f, a, b, graphs)

    phase = "fwd" if args.fwd_only else "fwd+bwd"
    print(f"# timing impl={args.impl} ({phase})", file=sys.stderr, flush=True)
    t_main = median_time(make_step(args.impl, args.fwd_only), fts, ld, ls,
                         reps=args.iters)
    t_base = (None if args.no_dense else
              median_time(make_step("dense", args.fwd_only), fts, ld, ls,
                          reps=args.iters))

    dt_tag = "" if args.dtype == "float32" else f", {args.dtype}"
    result = {
        "metric": f"edges/s ({args.impl} attention aggregate {phase}, "
                  f"N={args.n}, P={args.metapaths}, K={k}, D={d}{dt_tag})",
        "value": total_edges * k / t_main,
        "unit": "edges/s",
        "vs_baseline": t_base / t_main if t_base else None,
        "detail": {"t_main_ms": t_main * 1e3,
                   "t_dense_ms": t_base * 1e3 if t_base else None,
                   "total_edges": int(total_edges)},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
