"""Semi-supervised node-classification trainer.

Reproduces the reference training dynamics (ex_acm3025.py:121-293):
full-graph jit-compiled steps, Adam + global L2 over all params
(base_gattn.py:12-24 — including biases, see losses.l2_regularizer),
dropout 0.6 in training / 0 in eval, and the exact early-stopping policy
(ex_acm3025.py:225-240):

- checkpoint when val_acc >= best_acc AND val_loss <= best_loss;
- patience counter resets when val_acc >= best_acc OR val_loss <= best_loss;
- stop after ``patience`` non-improving epochs, restore best, test,
  then run KNN/KMeans embedding evaluation on the test nodes.

Checkpoints (train/checkpoint.py) hold params + opt state + epoch +
early-stop trackers + PRNG key → fully deterministic resume (SURVEY.md
§5.3-5.4).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from han_jax.datasets.base import HeteroDataset
from han_jax.graph.build import metapath_to_csr, metapath_to_dense
from han_jax.graph.containers import ell_from_csr
from han_jax.nn.losses import l2_regularizer, masked_accuracy, masked_softmax_cross_entropy
from han_jax.nn.models import GAT, HAN, HANShared
from han_jax.train.checkpoint import CheckpointManager
from han_jax.train.config import Config
from han_jax.train.eval_embed import kmeans_eval, knn_eval


def build_graphs(ds: HeteroDataset, cfg: Config):
    fmt = cfg.data.graph_format
    shards = cfg.mesh.graph_axis
    if shards > 1:
        # multi-device: the container IS the distribution strategy — the
        # same model code dispatches to the sharded backends
        # (ops/attention.py)
        if fmt in ("csr", "partitioned"):
            from han_jax.parallel.edge_partition import partition_csr

            return [partition_csr(
                        metapath_to_csr(a, edge_pad_to=cfg.data.edge_pad_to),
                        shards, edge_pad_to=cfg.data.edge_pad_to)
                    for a in ds.metapath_adjs]
        if fmt == "ring":
            # memory-scalable variant: features stay sharded, blocks rotate
            # between devices (parallel/ring_attn.py)
            from han_jax.parallel.ring_attn import partition_csr_2d

            return [partition_csr_2d(
                        metapath_to_csr(a, edge_pad_to=cfg.data.edge_pad_to),
                        shards, pad_to=cfg.data.edge_pad_to)
                    for a in ds.metapath_adjs]
        raise ValueError(
            f"graph_format {fmt!r} has no partitioned variant (use csr for "
            "sharded segment ops or ring)")
    if fmt == "dense":
        return [metapath_to_dense(a) for a in ds.metapath_adjs]
    csrs = [metapath_to_csr(a, edge_pad_to=cfg.data.edge_pad_to) for a in ds.metapath_adjs]
    if fmt == "csr":
        return csrs
    if fmt == "ell":
        return [ell_from_csr(c) for c in csrs]
    raise ValueError(f"unknown graph_format {fmt!r}")


def build_model(ds: HeteroDataset, cfg: Config) -> GAT | HAN | HANShared:
    m = cfg.model
    common = dict(hid_units=tuple(m.hid_units), n_heads=tuple(m.n_heads),
                  residual=m.residual, attn_drop=m.attn_drop,
                  ffd_drop=m.ffd_drop, impl=m.impl,
                  dtype=jnp.dtype(m.dtype))
    if m.arch == "han":
        return HAN(n_classes=ds.n_classes, semantic_dim=m.semantic_dim,
                   vmap_towers=m.vmap_towers, **common)
    if m.arch == "han_shared":
        return HANShared(n_classes=ds.n_classes, semantic_dim=m.semantic_dim, **common)
    if m.arch == "gat":
        return GAT(n_classes=ds.n_classes, **common)
    raise ValueError(f"unknown arch {m.arch!r}")


@dataclasses.dataclass
class EarlyStopState:
    """Mirrors vlss_mn / vacc_mx / curr_step (ex_acm3025.py:159-161)."""

    best_val_loss: float = float("inf")
    best_val_acc: float = 0.0
    bad_epochs: int = 0

    def update(self, val_loss: float, val_acc: float) -> tuple[bool, bool]:
        """Returns (should_checkpoint, should_stop_now_if_patience_hit)."""
        improved_any = (val_acc >= self.best_val_acc) or (val_loss <= self.best_val_loss)
        improved_both = (val_acc >= self.best_val_acc) and (val_loss <= self.best_val_loss)
        if improved_any:
            self.best_val_acc = max(self.best_val_acc, val_acc)
            self.best_val_loss = min(self.best_val_loss, val_loss)
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return improved_both, not improved_any


class MetricLogger:
    """Structured jsonl metric logging (SURVEY.md §5.5)."""

    def __init__(self, path: str = "", echo: bool = True):
        self.path = pathlib.Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: dict[str, Any]) -> None:
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.echo:
            parts = " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items())
            print(parts, flush=True)


class Trainer:
    def __init__(self, ds: HeteroDataset, cfg: Config, *,
                 logger: MetricLogger | None = None, guard=None):
        self.ds = ds
        self.cfg = cfg
        # preemption flag polled at epoch boundaries (train/preempt.py)
        self.guard = guard
        self.logger = logger or MetricLogger(cfg.train.log_file)
        # multi-device: a ('graph', 'heads'[, 'mp']) mesh drives the
        # partitioned/stacked containers + sharded kernels (cfg.mesh;
        # SURVEY.md §2.3/§5.8)
        if cfg.mesh.graph_axis * cfg.mesh.head_axis * cfg.mesh.mp_axis > 1:
            from han_jax.parallel.mesh import make_mesh

            self.mesh = make_mesh(graph=cfg.mesh.graph_axis,
                                  heads=cfg.mesh.head_axis,
                                  mp=cfg.mesh.mp_axis)
        else:
            self.mesh = None
        # meta-path expert parallelism: vmapped tower stack over stacked
        # graphs, P axis pinned to the 'mp' mesh axis (nn/models.py)
        if cfg.mesh.mp_axis > 1:
            if cfg.mesh.graph_axis > 1:
                raise ValueError(
                    "mp_axis > 1 together with graph_axis > 1 is not "
                    "supported: meta-path towers shard over 'mp' on "
                    "unpartitioned graphs only")
            cfg.model.vmap_towers = True
        self._ep = cfg.model.vmap_towers
        if self._ep and cfg.model.arch != "han":
            raise ValueError("vmap_towers requires arch='han'")
        graphs = build_graphs(ds, cfg)
        if self._ep:
            from han_jax.graph.stack import stack_graphs

            self.graphs = stack_graphs(graphs)
        else:
            self.graphs = graphs
        self.model = build_model(ds, cfg)
        if cfg.data.featype == "adj":
            # ablation: each tower's input features are its meta-path's dense
            # adjacency rows (ex_acm3025.py:92-93 `fea_list = adj_list`)
            xs = [jnp.asarray(a.toarray().astype(np.float32))
                  for a in ds.metapath_adjs]
        else:
            x = jnp.asarray(ds.features)
            xs = [x for _ in ds.metapath_adjs]
        self.xs = jnp.stack(xs) if self._ep else xs
        self._total_edges = int(sum(a.nnz for a in ds.metapath_adjs))
        self.labels = jnp.asarray(ds.labels)
        self.masks = {
            "train": jnp.asarray(ds.train_mask),
            "val": jnp.asarray(ds.val_mask),
            "test": jnp.asarray(ds.test_mask),
        }
        self.tx = optax.adam(cfg.train.lr)
        self._is_han = cfg.model.arch.startswith("han")
        self._build_steps()

    # -- model application helpers --------------------------------------
    # graphs/features/labels are passed as jit ARGUMENTS, not captured in
    # closures, so they are not baked into the program as constants
    def _apply(self, params, graphs, xs, *, deterministic, rng=None):
        args = (graphs, xs) if self._is_han else (graphs[0], xs[0])
        kwargs = {"deterministic": deterministic}
        if rng is not None:
            kwargs["rngs"] = {"dropout": rng}
        out = self.model.apply(params, *args, **kwargs)
        if self._is_han:
            logits, embed, alphas = out[0], out[1], out[2]
        else:
            logits, embed, alphas = out, out, None
        return logits, embed, alphas

    def _build_steps(self):
        l2c = self.cfg.train.l2_coef
        n_mp = len(self.ds.metapath_adjs)

        def train_step(params, opt_state, rng, graphs, xs, labels, mask):
            rng, sub = jax.random.split(rng)

            def loss_fn(p):
                logits, _, alphas = self._apply(
                    p, graphs, xs, deterministic=False, rng=sub)
                data_loss = masked_softmax_cross_entropy(logits, labels, mask)
                return data_loss + l2_regularizer(p, l2c), (logits, alphas)

            (loss, (logits, alphas)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = self.tx.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            acc = masked_accuracy(logits, labels, mask)
            mean_alphas = (jnp.mean(alphas, axis=0) if alphas is not None
                           else jnp.zeros((n_mp,)))
            return params, opt_state, rng, loss, acc, mean_alphas

        def eval_step(params, graphs, xs, labels, mask):
            logits, embed, _ = self._apply(params, graphs, xs, deterministic=True)
            loss = masked_softmax_cross_entropy(logits, labels, mask)
            acc = masked_accuracy(logits, labels, mask)
            return loss, acc, logits, embed

        jit_train = jax.jit(train_step)
        jit_eval = jax.jit(eval_step)
        self.jit_train = jit_train  # for lower_train_step

        def run_train(params, opt_state, rng):
            with self._mesh_ctx():
                return jit_train(params, opt_state, rng, self.graphs,
                                 self.xs, self.labels, self.masks["train"])

        def run_eval(params, mask):
            with self._mesh_ctx():
                return jit_eval(params, self.graphs, self.xs, self.labels, mask)

        self.train_step = run_train
        self.eval_step = run_eval

    def _mesh_ctx(self):
        import contextlib

        return (jax.set_mesh(self.mesh) if self.mesh is not None
                else contextlib.nullcontext())

    def lower_train_step(self, params, opt_state, rng):
        """The train step lowered for these arguments and this trainer's
        graphs (``.compile().memory_analysis()`` sizes it)."""
        with self._mesh_ctx():
            return self.jit_train.lower(params, opt_state, rng, self.graphs,
                                        self.xs, self.labels,
                                        self.masks["train"])

    def init_params(self):
        rng = jax.random.PRNGKey(self.cfg.train.seed)
        args = (self.graphs, self.xs) if self._is_han else (self.graphs[0], self.xs[0])
        with self._mesh_ctx():
            return self.model.init(rng, *args)

    # -- checkpointing ----------------------------------------------------
    def _ckpt_manager(self):
        return CheckpointManager(
            pathlib.Path(self.cfg.train.checkpoint_dir) / self.ds.name)

    def fit(self, *, resume: bool = False) -> dict[str, Any]:
        cfg = self.cfg.train
        params = self.init_params()
        opt_state = self.tx.init(params)
        rng = jax.random.PRNGKey(cfg.seed + 1)
        es = EarlyStopState()
        best = {"params": params, "epoch": -1}
        mgr = self._ckpt_manager()
        start_epoch = 0
        best_step = -1  # epoch of the last *best* (not periodic) save
        if resume:
            restored = self.restore_latest()
            if restored is not None:
                # deterministic resume (SURVEY.md §5.3): the checkpoint holds
                # the complete post-epoch state, so the continued run emits
                # the exact trajectory of an uninterrupted one
                init_params = params  # deterministic from seed
                params = restored["params"]
                opt_state = restored["opt_state"]
                rng = restored["rng"]
                es.best_val_loss = float(restored["best_val_loss"])
                es.best_val_acc = float(restored["best_val_acc"])
                es.bad_epochs = int(restored["bad_epochs"])
                start_epoch = int(restored["epoch"]) + 1
                # best params are restored from the recorded *best* step, not
                # from the latest (possibly periodic) save — the reference
                # policy tests on the best-val checkpoint (ex_acm3025.py:247)
                best_step = int(restored["best_step"])
                if best_step == int(restored["epoch"]):
                    best = {"params": params, "epoch": best_step}
                elif best_step >= 0:
                    at_best = self.restore_latest(step=best_step)
                    best = {"params": at_best["params"], "epoch": best_step}
                else:  # no best save yet — same as the uninterrupted run
                    best = {"params": init_params, "epoch": -1}
        t_start = time.time()

        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            params, opt_state, rng, tr_loss, tr_acc, alphas = self.train_step(
                params, opt_state, rng)
            tr_loss, tr_acc = float(tr_loss), float(tr_acc)  # forces the step
            t_train = time.time() - t0
            t1 = time.time()
            vl_loss, vl_acc, _, _ = self.eval_step(params, self.masks["val"])
            vl_loss, vl_acc = float(vl_loss), float(vl_acc)
            t_eval = time.time() - t1
            self.logger.log({
                "epoch": epoch, "train_loss": tr_loss, "train_acc": tr_acc,
                "val_loss": vl_loss, "val_acc": vl_acc,
                "semantic_alphas": [round(float(a), 4) for a in np.asarray(alphas)],
                # train step alone; eval timed separately so edges_per_s
                # reflects the train step (SURVEY.md §5.5)
                "step_time_s": t_train,
                "eval_time_s": t_eval,
                # throughput counter (SURVEY.md §5.1/§5.5): real meta-path
                # edges × heads processed per second this epoch
                "edges_per_s": (self._total_edges * self.cfg.model.n_heads[0]
                                / t_train),
            })
            ckpt, _ = es.update(vl_loss, vl_acc)
            periodic = cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0
            if ckpt:
                best = {"params": params, "epoch": epoch}
                best_step = epoch
            if ckpt or periodic:
                # save-on-best preserves reference dynamics (ex_acm3025.py:
                # 226-229); the periodic save is the preemption-recovery
                # point (SURVEY.md §5.3) — both carry the full resume state
                mgr.save(epoch, self._state(
                    params, opt_state, rng, es, epoch, best_step))
            if es.bad_epochs >= cfg.patience:
                self.logger.log({"early_stop": epoch,
                                 "best_val_loss": es.best_val_loss,
                                 "best_val_acc": es.best_val_acc})
                break
            if self.guard is not None and self.guard.triggered:
                # preemption (SURVEY.md §5.3): persist the full resume
                # state now and stop cleanly; fit(resume=True) continues
                # the exact trajectory
                mgr.save(epoch, self._state(
                    params, opt_state, rng, es, epoch, best_step))
                self.logger.log({"preempted_at": epoch})
                self.final_params = params
                return {"preempted": True,
                        "train_time_s": time.time() - t_start}

        # restore best & final evaluation (ex_acm3025.py:247-291)
        params = best["params"]
        ts_loss, ts_acc, _, embed = self.eval_step(params, self.masks["test"])
        result = {
            "test_loss": float(ts_loss), "test_acc": float(ts_acc),
            "best_epoch": best["epoch"],
            "train_time_s": time.time() - t_start,
        }
        from han_jax.utils.prof import device_memory_stats

        hbm = [s.get("bytes_in_use") for s in device_memory_stats()]
        if any(b is not None for b in hbm):
            result["hbm_bytes_in_use"] = [b for b in hbm if b is not None]
        if self._is_han:
            emb = np.asarray(embed)[np.asarray(self.ds.test_mask)]
            lab = self.ds.labels[self.ds.test_mask]
            result.update(knn_eval(emb, lab, seed=cfg.seed))
            result.update(kmeans_eval(emb, lab, seed=cfg.seed))
        self.logger.log({k: v for k, v in result.items()})
        self.final_params = params
        return result

    def _state(self, params, opt_state, rng, es: EarlyStopState,
               epoch: int, best_step: int) -> dict:
        return {
            "params": params,
            "opt_state": opt_state,
            "rng": rng,
            "epoch": jnp.asarray(epoch),
            "best_val_loss": jnp.asarray(es.best_val_loss),
            "best_val_acc": jnp.asarray(es.best_val_acc),
            "bad_epochs": jnp.asarray(es.bad_epochs),
            # which saved step is the last save-on-best (vs periodic) — lets
            # resume restore best params separately from latest state
            "best_step": jnp.asarray(best_step),
        }

    def restore_latest(self, step: int | None = None):
        """Deterministic resume: params + opt state + PRNG + early-stop
        trackers (SURVEY.md §5.3). ``step=None`` restores the latest save."""
        mgr = self._ckpt_manager()
        if step is None:
            step = mgr.latest_step()
        if step is None:
            return None
        params = self.init_params()
        opt_state = self.tx.init(params)
        template = {
            "params": params, "opt_state": opt_state,
            "rng": jax.random.PRNGKey(0), "epoch": jnp.asarray(0),
            "best_val_loss": jnp.asarray(0.0), "best_val_acc": jnp.asarray(0.0),
            "bad_epochs": jnp.asarray(0), "best_step": jnp.asarray(-1),
        }
        return mgr.restore(step, template)


def run(cfg: Config, ds: HeteroDataset | None = None) -> dict[str, Any]:
    """One-call train+eval entry point (the ex_acm3025.py equivalent).

    Inductive multi-graph datasets (PPI, reference utils/process_ppi.py)
    route to the InductiveTrainer with the mesh's graph axis as the DP
    axis; everything else uses the full-graph Trainer.
    """
    if ds is None:
        from han_jax.datasets.registry import load_dataset

        ds = load_dataset(cfg.data.dataset)
    from han_jax.datasets.ppi import MultiGraphDataset

    if isinstance(ds, MultiGraphDataset):
        from han_jax.train.inductive import InductiveTrainer

        mesh = None
        if cfg.mesh.graph_axis > 1:
            from han_jax.parallel.mesh import make_mesh

            mesh = make_mesh(graph=cfg.mesh.graph_axis)
        trainer = InductiveTrainer(
            ds, hid_units=tuple(cfg.model.hid_units),
            n_heads=tuple(cfg.model.n_heads), lr=cfg.train.lr,
            l2_coef=cfg.train.l2_coef, residual=cfg.model.residual,
            attn_drop=cfg.model.attn_drop, ffd_drop=cfg.model.ffd_drop,
            patience=cfg.train.patience, impl=cfg.model.impl,
            batch_size=max(2, cfg.mesh.graph_axis), mesh=mesh,
            seed=cfg.train.seed,
            # full config threading: the inductive
            # trainer shares the resilience contract of the other trainers
            checkpoint_dir=cfg.train.checkpoint_dir,
            checkpoint_every=cfg.train.checkpoint_every,
            logger=MetricLogger(cfg.train.log_file))
        result = trainer.fit(epochs=cfg.train.epochs)
        return {k: v for k, v in result.items() if k != "history"}
    if cfg.train.sampled:
        # mini-batch neighbor-sampled training (>HBM graphs): the ell
        # backend over L-hop blocks; sampler='device' keeps the CSRs
        # HBM-resident and samples inside the jitted step
        from han_jax.train.sampled import DPSampledTrainer, SampledTrainer

        if cfg.model.impl not in ("auto", "ell"):
            cfg.model.impl = "auto"
        if cfg.mesh.graph_axis > 1:
            from han_jax.parallel.mesh import make_mesh

            trainer = DPSampledTrainer(
                ds, cfg, mesh=make_mesh(graph=cfg.mesh.graph_axis),
                batch_size=cfg.train.batch_size, fanout=cfg.train.fanout,
                sampler=cfg.train.sampler)
        else:
            trainer = SampledTrainer(
                ds, cfg, batch_size=cfg.train.batch_size,
                fanout=cfg.train.fanout, sampler=cfg.train.sampler)
        return trainer.fit()
    return Trainer(ds, cfg).fit()
