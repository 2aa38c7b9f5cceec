"""Smoke test of han_jax on an NVIDIA GPU: the main paths, end to end.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --cards 4     # four GPUs: the multi-card comparisons

Phases (one process; any failure exits non-zero; phase 4 runs before
phase 3 so that its peak-memory reading is not the parity runs'):

1. device  — JAX must find a GPU (never falls back to the CPU); prints the
   device, ``nvidia-smi``'s name and power limit, JAX version, XLA_FLAGS
   and the compile-cache directory.
2. graph   — a DBLP-shaped heterogeneous graph from ``--seed``
   (graph/synthetic.dblp_shaped: 4,057 authors, 334 features, 4 classes,
   APA / APCPA / APTPA with ~11.1k / ~5.0M / ~12.9M edges).
3. parity  — the csr and ell attention backends, forward and gradients,
   on APCPA at K=8, D=8 against the dense oracle run at "highest" matmul
   precision; then the whole HAN forward as the program runs it against
   the dense model at "highest".
4. train   — ``trainer.run`` with the dblp preset (reference widths,
   dropout 0.6) for 5 epochs, once on csr graphs and once on
   dense graphs: step times, losses, peak memory, the compiled step's
   memory analysis.
5. sampled — 20 ``SampledTrainer(sampler="device")`` steps on the
   bench_scale graph (500,000 nodes, 100M edges over two meta-paths).

``--cards 4`` runs, after phase 1, only: edge-partitioned full-graph
training on a graph=4 mesh against one card, and data-parallel sampled
training (host sampler) against one card, both with dropout off.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Tolerances (see CHANGES.md for the reasons):
# the attention op differs from the oracle only in summation order (csr has
# no matmul, ell's neighbor sum runs at HIGHEST)
OP_RTOL, OP_ATOL = 1e-4, 1e-5
# the HAN forward at "highest" against the dense model at "highest": the
# same arithmetic up to summation order, through two softmaxes
FWD_HIGHEST_TOL = 1e-4
# the HAN forward at the default matmul precision (TF32 on the GPU for the
# f32 feature transforms, unit rounding 2^-11) against the dense model at
# "highest". Rounding the inputs of those transforms to TF32 moves the
# logits by about 3.5e-4 of their scale; the same forward in bf16 (unit
# rounding 2^-8) by about 2.4e-3, and the parity phase checks that it
# fails this bound
FWD_DEFAULT_TOL = 1e-3
# multi-card against one card, dropout off: reduction order (GPU
# scatter-add atomics, cross-device sums) compounded by Adam steps
MULTI_RTOL, MULTI_ATOL = 1e-3, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got, ref, *, rtol: float, atol: float) -> None:
    """Element-wise |got - ref| <= atol + rtol·|ref|; prints the errors and
    raises when any element is outside."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - ref)
    rel = err / np.maximum(np.abs(ref), 1e-30)
    ok = bool(np.all(err <= atol + rtol * np.abs(ref)))
    log(f"  {name}: max_abs_err={err.max():.3e} max_rel_err={rel.max():.3e} "
        f"(rtol={rtol:g} atol={atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside tolerance")


def check_scaled(name: str, got, ref, *, tol: float) -> None:
    """max |got - ref| <= tol · max |ref|: an error bound relative to the
    output's scale, for outputs with entries near zero."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    rel = err / np.maximum(np.abs(ref), 1e-30)
    ok = float(err.max()) <= tol * scale
    log(f"  {name}: max_abs_err={err.max():.3e} max_rel_err={rel.max():.3e} "
        f"scale={scale:.3e} (tol={tol:g} of scale) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside tolerance")


# -- phase 1 ----------------------------------------------------------------

def device_phase(n_cards: int):
    import jax

    from han_jax.utils.cache import setup_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r} "
                 f"({len(devices)} device(s)); nothing was run")
    if len(devices) < n_cards:
        sys.exit(f"chip_smoke: --cards {n_cards} needs {n_cards} GPUs, "
                 f"JAX found {len(devices)}")
    cache = setup_compile_cache()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"unavailable ({e})"
    log(f"device: kind={devices[0].device_kind} count={len(devices)} "
        f"platform={devices[0].platform}")
    log("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(smi)
    log(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}  "
        f"compile_cache={cache}")
    return devices


# -- phase 2 ----------------------------------------------------------------

def graph_phase(seed: int, n_nodes: int = 4057):
    from han_jax.graph.synthetic import dblp_shaped

    t0 = time.perf_counter()
    n_train = 800 * n_nodes // 4057
    n_val = 400 * n_nodes // 4057
    ds = dblp_shaped(seed=seed, n_nodes=n_nodes, n_train=n_train, n_val=n_val)
    edges = {name: int(a.nnz) + ds.n_nodes
             for name, a in zip(ds.metapath_names, ds.metapath_adjs)}
    log(f"graph: dblp_shaped seed={seed} nodes={ds.n_nodes} "
        f"features={ds.features.shape[1]} classes={ds.n_classes} "
        f"train/val/test={int(ds.train_mask.sum())}/{int(ds.val_mask.sum())}/"
        f"{int(ds.test_mask.sum())} edges(with self-loops)={edges} "
        f"built_in={time.perf_counter() - t0:.2f}s")
    return ds


# -- phase 3 ----------------------------------------------------------------

def op_parity_phase(ds, seed: int, k: int = 8, d: int = 8) -> None:
    import jax
    import jax.numpy as jnp

    from han_jax.graph.build import metapath_to_csr, metapath_to_dense
    from han_jax.graph.containers import ell_from_csr
    from han_jax.ops.attention import attention_aggregate

    adj = ds.metapath_adjs[1]  # APCPA
    csr = metapath_to_csr(adj)
    graphs = {"csr": csr, "ell": ell_from_csr(csr),
              "dense": metapath_to_dense(adj)}
    n = ds.n_nodes
    rng = np.random.default_rng(seed)
    fts = jnp.asarray(rng.standard_normal((n, k, d), dtype=np.float32))
    ld = jnp.asarray(rng.standard_normal((n, k), dtype=np.float32))
    ls = jnp.asarray(rng.standard_normal((n, k), dtype=np.float32))
    cot = jnp.asarray(rng.standard_normal((n, k, d), dtype=np.float32))
    log(f"parity (attention op, APCPA edges={csr.n_edges}, K={k}, D={d}, "
        f"ell fanout={graphs['ell'].fanout}):")

    def run(impl):
        def loss(g, f, a, b):
            out = attention_aggregate(g, f, a, b, impl=impl)
            return jnp.sum(out * cot), out

        step = jax.jit(jax.value_and_grad(loss, argnums=(1, 2, 3), has_aux=True))
        (_, out), grads = step(graphs[impl], fts, ld, ls)
        return [np.asarray(out)] + [np.asarray(x) for x in grads]

    with jax.default_matmul_precision("highest"):
        ref = run("dense")
    for impl in ("csr", "ell"):
        got = run(impl)
        for name, a, b in zip(("out", "d_fts", "d_logit_dst", "d_logit_src"),
                              got, ref):
            check_close(f"{impl} {name}", a, b, rtol=OP_RTOL, atol=OP_ATOL)
    del graphs


def forward_parity_phase(ds, seed: int) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from han_jax.graph.build import metapath_to_dense
    from han_jax.train.config import preset
    from han_jax.train.trainer import build_graphs, build_model

    cfg = preset("dblp")
    graphs = build_graphs(ds, cfg)
    model = build_model(ds, cfg)
    dense_model = dataclasses.replace(model, impl="dense")
    dense_graphs = [metapath_to_dense(a) for a in ds.metapath_adjs]
    x = jnp.asarray(ds.features)
    xs = [x for _ in graphs]
    params = model.init(jax.random.PRNGKey(seed), graphs, xs)
    fwd = jax.jit(lambda p, g, x: model.apply(p, g, x)[:2])
    fwd_dense = jax.jit(lambda p, g, x: dense_model.apply(p, g, x)[:2])
    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(o) for o in fwd_dense(params, dense_graphs, xs)]
        hi = [np.asarray(o) for o in fwd(params, graphs, xs)]
    prog = [np.asarray(o) for o in fwd(params, graphs, xs)]
    log(f"parity (HAN forward, {cfg.data.graph_format} graphs, reference "
        f"widths, dropout off) against the dense model at 'highest':")
    for name, a, b in zip(("logits", "embedding"), hi, ref):
        check_scaled(f"{name} at 'highest'", a, b, tol=FWD_HIGHEST_TOL)
    for name, a, b in zip(("logits", "embedding"), prog, ref):
        check_scaled(f"{name} at default precision", a, b, tol=FWD_DEFAULT_TOL)
    # the default-precision gate must tell a bf16 slip from TF32: the same
    # forward with bf16 features and transforms has to fail it
    bf16 = dataclasses.replace(model, dtype=jnp.bfloat16)
    low = np.asarray(jax.jit(lambda p, g, x: bf16.apply(p, g, x)[0])(
        params, graphs, xs), np.float64)
    err = float(np.abs(low - ref[0]).max())
    scale = float(np.abs(ref[0]).max())
    ok = err > FWD_DEFAULT_TOL * scale
    log(f"  logits in bf16: max_abs_err={err:.3e} scale={scale:.3e} (must "
        f"exceed tol={FWD_DEFAULT_TOL:g} of scale) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a bf16 forward passes the default-precision "
                             "tolerance, which then cannot catch one")


# -- phase 4 ----------------------------------------------------------------

def train_phase(ds, seed: int, epochs: int, fmt: str, out_dir: pathlib.Path):
    import jax

    from han_jax.train import trainer
    from han_jax.train.config import preset

    cfg = preset("dblp")
    cfg.data.graph_format = fmt
    cfg.model.impl = "auto"
    cfg.train.seed = seed
    cfg.train.epochs = epochs
    cfg.train.patience = epochs + 1
    cfg.train.checkpoint_dir = str(out_dir / f"ckpt_{fmt}")
    cfg.train.log_file = str(out_dir / f"train_{fmt}.jsonl")
    pathlib.Path(cfg.train.log_file).unlink(missing_ok=True)

    probe = trainer.Trainer(ds, cfg, logger=trainer.MetricLogger(echo=False))
    params = probe.init_params()
    compiled = probe.lower_train_step(
        params, probe.tx.init(params), jax.random.PRNGKey(0)).compile()
    mem = compiled.memory_analysis()
    del probe, params, compiled

    result = trainer.run(cfg, ds)
    rows = [json.loads(line) for line in open(cfg.train.log_file)
            if '"train_loss"' in line]
    steps = [r["step_time_s"] for r in rows]
    losses = [r["train_loss"] for r in rows]
    if len(rows) != epochs or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train[{fmt}]: epochs={len(rows)} losses={losses}")
    if not np.isfinite(result["test_loss"]):
        raise AssertionError(f"train[{fmt}]: test_loss={result['test_loss']}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"train[{fmt}]: epochs={epochs} step_s(first)={steps[0]:.4f} "
        f"step_s(rest, median)={float(np.median(steps[1:])):.6f} "
        f"step_s(rest)={[round(s, 6) for s in steps[1:]]}")
    log(f"train[{fmt}]: train_loss={[round(v, 5) for v in losses]} "
        f"test_loss={result['test_loss']:.5f} test_acc={result['test_acc']:.4f}")
    log(f"train[{fmt}]: peak_bytes_in_use(process so far)={peak} "
        f"memory_analysis: temp={mem.temp_size_in_bytes} "
        f"argument={mem.argument_size_in_bytes} "
        f"output={mem.output_size_in_bytes} "
        f"generated_code={mem.generated_code_size_in_bytes}")


# -- phase 5 ----------------------------------------------------------------

def sampled_phase(seed: int, n_nodes: int, degree: int, steps: int,
                  batch_size: int = 512, fanout: int = 16) -> None:
    from han_jax.graph.synthetic import scale_hetero
    from han_jax.train.config import preset
    from han_jax.train.sampled import SampledTrainer

    t0 = time.perf_counter()
    ds = scale_hetero(n_nodes=n_nodes, avg_degree=degree,
                      n_train=batch_size * (steps + 1), n_val=batch_size,
                      seed=seed)
    cfg = preset("acm")  # reference widths: hid 8, heads (8, 1), dropout 0.6
    cfg.train.seed = seed
    t = SampledTrainer(ds, cfg, batch_size=batch_size, fanout=fanout,
                       eval_batches=1, sampler="device")
    setup_s = time.perf_counter() - t0
    run = t.time_steps(steps)
    if run["steps"] != steps or not np.isfinite(run["loss"]):
        raise AssertionError(f"sampled: {run['steps']} steps, loss {run['loss']}")
    loop_s = float(np.sum(run["step_s"]))
    edges = sum(int(a.nnz) for a in ds.metapath_adjs)
    log(f"sampled[device]: nodes={n_nodes} edges={edges} batch={batch_size} "
        f"fanout={fanout} setup_s={setup_s:.2f} first_step_s="
        f"{run['first_step_s']:.3f} steps={run['steps']} "
        f"step_ms(median)={float(np.median(run['step_s'])) * 1e3:.4f} "
        f"sampled_edges/s={run['sampled_edges'] / loop_s:.6e} "
        f"loss={run['loss']:.5f}")


# -- --cards 4 ----------------------------------------------------------------

def _epoch_losses(rows) -> np.ndarray:
    return np.asarray([[r["train_loss"], r["val_loss"]] for r in rows
                       if "train_loss" in r])


class _Rows:
    """Metric logger that keeps the records (no echo)."""

    def __init__(self):
        self.rows = []

    def log(self, rec):
        self.rows.append(rec)


def partitioned_phase(ds, seed: int, epochs: int, cards: int,
                      out_dir: pathlib.Path) -> None:
    from han_jax.train.config import preset
    from han_jax.train.trainer import Trainer

    def train(graph_axis):
        cfg = preset("dblp")
        cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
        cfg.train.seed = seed
        cfg.train.epochs = epochs
        cfg.train.patience = epochs + 1
        cfg.train.checkpoint_dir = str(out_dir / f"ckpt_graph{graph_axis}")
        cfg.mesh.graph_axis = graph_axis
        rows = _Rows()
        t = Trainer(ds, cfg, logger=rows)
        t.fit()
        return _epoch_losses(rows.rows), t

    one, _ = train(1)
    many, t = train(cards)
    log(f"multi[partitioned csr, graph={cards}]: container="
        f"{type(t.graphs[0]).__name__} epochs={epochs} dropout=0")
    log(f"  one card  train/val loss: {one.tolist()}")
    log(f"  {cards} cards train/val loss: {many.tolist()}")
    check_close(f"partitioned x{cards} vs one card", many, one,
                rtol=MULTI_RTOL, atol=MULTI_ATOL)


def dp_sampled_phase(seed: int, cards: int, out_dir: pathlib.Path, *,
                     n_nodes: int = 100_000, epochs: int = 3,
                     batch_size: int = 512, n_batches: int = 8) -> None:
    from han_jax.graph.synthetic import scale_hetero
    from han_jax.parallel.mesh import make_mesh
    from han_jax.train.config import preset
    from han_jax.train.sampled import DPSampledTrainer, SampledTrainer

    ds = scale_hetero(n_nodes=n_nodes, avg_degree=10,
                      n_train=batch_size * n_batches, n_val=batch_size,
                      seed=seed)
    # fanout >= max degree (self-loop included): every block takes each
    # seed's whole neighborhood, so one card and the shards see the same
    # neighbors whatever their sampling streams
    fanout = 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)

    def cfg(tag):
        c = preset("acm")
        c.model.attn_drop = c.model.ffd_drop = 0.0
        c.train.seed = seed
        c.train.epochs = epochs
        c.train.patience = epochs + 1
        c.train.checkpoint_dir = str(out_dir / f"ckpt_{tag}")
        return c

    single = _Rows()
    SampledTrainer(ds, cfg("sampled1"), batch_size=batch_size, fanout=fanout,
                   eval_batches=1, logger=single).fit()
    dp = _Rows()
    DPSampledTrainer(ds, cfg(f"sampled{cards}"), mesh=make_mesh(graph=cards),
                     batch_size=batch_size, fanout=fanout, eval_batches=1,
                     logger=dp).fit()
    one, many = _epoch_losses(single.rows), _epoch_losses(dp.rows)
    log(f"multi[DP sampled, host sampler, graph={cards}]: batch={batch_size} "
        f"fanout={fanout} epochs={epochs} dropout=0")
    log(f"  one card  train/val loss: {one.tolist()}")
    log(f"  {cards} cards train/val loss: {many.tolist()}")
    check_close(f"DP sampled x{cards} vs one card", many, one,
                rtol=MULTI_RTOL, atol=MULTI_ATOL)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=1, choices=[1, 4])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    epochs = 5

    import han_jax  # noqa: F401  (fails here when run outside the repo)

    t_start = time.perf_counter()
    devices = device_phase(args.cards)
    out_dir = ROOT / "chiprun_out" / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.cards > 1:
        ds = graph_phase(args.seed)
        partitioned_phase(ds, args.seed, epochs, args.cards, out_dir)
        dp_sampled_phase(args.seed, args.cards, out_dir)
    else:
        ds = graph_phase(args.seed)
        # training first, so the csr run's peak memory is its own (the
        # device's peak counter covers the whole process)
        for fmt in ("csr", "dense"):
            train_phase(ds, args.seed, epochs, fmt, out_dir)
        op_parity_phase(ds, args.seed)
        forward_parity_phase(ds, args.seed)
        del ds
        # the bench_scale.py config: 500k nodes × 100 edges × 2 meta-paths
        sampled_phase(args.seed, 500_000, 100, steps=20)
    log(f"total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
