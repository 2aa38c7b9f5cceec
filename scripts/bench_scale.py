"""Scale benchmark: sampled HAN training on graphs too big for dense forms.

The BASELINE.json scaling config — "synthetic 100M-edge heterogeneous
graph, meta-path neighbor sampling" — exercised end to end: a large CSR
heterogeneous graph is generated directly (graph/synthetic.scale_hetero),
and training runs over seed-node batches with L-hop bounded-fanout sampled
blocks (train/sampled.py) with one-ahead host prefetch.

Prints one JSON line: sampled-edge throughput (edges aggregated per second,
forward+backward), the median step time, and the set-up and first-step
(compile) times. Runs on a GPU only.

    python scripts/bench_scale.py                        # 10M edges (quick)
    python scripts/bench_scale.py --nodes 500000 --avg-degree 100  # 100M
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=500_000)
    p.add_argument("--avg-degree", type=int, default=20)
    p.add_argument("--metapaths", type=int, default=2)
    p.add_argument("--feats", type=int, default=64)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--fanout", type=int, default=16)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--sampler", default="host", choices=["host", "device"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="device mode: scan C steps per jit dispatch")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax

    from han_jax.utils.cache import setup_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_scale.py measures a GPU; JAX found {dev.platform!r}")
    setup_compile_cache()

    from han_jax.graph.synthetic import scale_hetero
    from han_jax.train.config import preset
    from han_jax.train.sampled import SampledTrainer

    t0 = time.perf_counter()
    spc = args.steps_per_call
    ds = scale_hetero(n_nodes=args.nodes, avg_degree=args.avg_degree,
                      n_metapaths=args.metapaths, n_feats=args.feats,
                      n_classes=args.classes,
                      n_train=args.batch_size * (args.steps + 1) * spc,
                      n_val=args.batch_size, seed=args.seed)
    cfg = preset("acm")
    cfg.model.dtype = args.dtype
    cfg.train.log_file = ""
    trainer = SampledTrainer(ds, cfg, batch_size=args.batch_size,
                             fanout=args.fanout, eval_batches=1,
                             sampler=args.sampler, steps_per_call=spc)
    setup_s = time.perf_counter() - t0
    run = trainer.time_steps(args.steps)
    total_edges = sum(int(a.nnz) for a in ds.metapath_adjs)
    heads = cfg.model.n_heads[0]
    loop_s = float(np.sum(run["step_s"]))
    result = {
        "metric": (f"sampled-edges/s (train fwd+bwd, sampler={args.sampler}, "
                   f"dtype={args.dtype}, spc={spc}, N={args.nodes}, "
                   f"E={total_edges}, B={args.batch_size}, f={args.fanout})"),
        "value": run["sampled_edges"] * heads / loop_s,
        "unit": "edges/s",
        "detail": {
            "steps": run["steps"],
            "step_time_ms_median": float(np.median(run["step_s"])) * 1e3 / spc,
            "sampled_edges_per_step": run["sampled_edges"] / max(run["steps"], 1),
            "setup_s": setup_s, "first_step_s": run["first_step_s"],
            "final_loss": run["loss"], "graph_edges": total_edges,
        },
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
