"""Inductive multi-graph trainer (PPI-style): GAT over padded graph batches
with multi-label sigmoid loss and micro-F1 (reference base_gattn.py:50-59,
71-94; batching semantics from utils/process_ppi.py).

Data parallelism: the graph batch axis is sharded over the mesh 'graph'
axis with NamedSharding; parameters stay replicated and XLA psums the
gradients — the DP row of SURVEY.md §2.3.
"""

from __future__ import annotations

import pathlib
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from han_jax.datasets.ppi import MultiGraphDataset
from han_jax.graph.containers import DenseGraph
from han_jax.nn.losses import l2_regularizer, masked_sigmoid_cross_entropy, micro_f1
from han_jax.nn.models import GAT
from han_jax.parallel.mesh import GRAPH_AXIS
from han_jax.train.checkpoint import CheckpointManager


class InductiveTrainer:
    """Resilience contract matches the full-graph/sampled trainers
    (SURVEY.md §5.3-5.4): save-on-best + periodic checkpoints, full
    deterministic resume (params/opt state/PRNG/early-stop trackers/epoch),
    and preemption-guard polling at epoch boundaries — the reference
    checkpoints even its toy trainer (ex_acm3025.py:154,225-247)."""

    def __init__(self, ds: MultiGraphDataset, *, hid_units=(256, 256),
                 n_heads=(4, 4, 6), lr=0.005, l2_coef=0.0, residual=True,
                 attn_drop: float = 0.0, ffd_drop: float = 0.0,
                 patience: int | None = None, impl: str = "auto",
                 batch_size: int = 2, mesh=None, seed: int = 0,
                 checkpoint_dir: str = "", checkpoint_every: int = 0,
                 logger=None, guard=None):
        self.ds = ds
        self.mesh = mesh
        self.batch_size = batch_size
        self.l2_coef = l2_coef
        self.patience = patience
        self.attn_drop = attn_drop
        self.ffd_drop = ffd_drop
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.logger = logger
        self.guard = guard
        self.seed = seed
        self._rng = jax.random.PRNGKey(seed + 1)
        if impl not in ("auto", "dense"):
            # the padded multi-graph batch (G, N_max, N_max) vmaps one
            # DenseGraph per component (reference process_ppi.py pads dense
            # adjs); sparse containers have per-graph static metadata and
            # cannot share one vmapped program
            import warnings

            warnings.warn(f"InductiveTrainer ignores impl={impl!r}: padded "
                          "multi-graph batching is dense by design")
        n_labels = ds.labels.shape[-1]
        self.model = GAT(n_classes=n_labels, hid_units=hid_units,
                         n_heads=n_heads, residual=residual, impl="dense",
                         attn_drop=attn_drop, ffd_drop=ffd_drop)
        self.tx = optax.adam(lr)
        n_max = ds.adj.shape[1]
        adj0 = DenseGraph(adj=jnp.asarray(ds.adj[0]), n_nodes=n_max)
        self.params = self.model.init(
            jax.random.PRNGKey(seed), adj0, jnp.asarray(ds.features[0]))
        self.opt_state = self.tx.init(self.params)
        self._build()

    def _build(self):
        n_max = self.ds.adj.shape[1]

        def batched_apply(params, adj_b, x_b, rng=None):
            def one(adj, x, r):
                g = DenseGraph(adj=adj, n_nodes=n_max)
                if r is None:
                    return self.model.apply(params, g, x)
                return self.model.apply(params, g, x, deterministic=False,
                                        rngs={"dropout": r})
            if rng is None:
                return jax.vmap(lambda a, x: one(a, x, None))(adj_b, x_b)
            rngs = jax.random.split(rng, adj_b.shape[0])
            return jax.vmap(one)(adj_b, x_b, rngs)

        def loss_fn(params, adj_b, x_b, y_b, m_b, rng):
            logits = batched_apply(params, adj_b, x_b, rng)  # (B, N, C)
            per_graph = jax.vmap(masked_sigmoid_cross_entropy)(logits, y_b, m_b)
            return jnp.mean(per_graph) + l2_regularizer(params, self.l2_coef), logits

        use_dropout = self.attn_drop > 0.0 or self.ffd_drop > 0.0

        def train_step(params, opt_state, adj_b, x_b, y_b, m_b, rng):
            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, adj_b, x_b, y_b, m_b,
                                       rng if use_dropout else None)
            updates, opt_state = self.tx.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, logits

        def eval_step(params, adj_b, x_b, y_b, m_b):
            logits = batched_apply(params, adj_b, x_b)
            per_graph = jax.vmap(masked_sigmoid_cross_entropy)(logits, y_b, m_b)
            return jnp.mean(per_graph), logits

        if self.mesh is not None:
            batch_sharding = NamedSharding(self.mesh, P(GRAPH_AXIS))
            self.train_step = jax.jit(
                train_step,
                in_shardings=(None, None) + (batch_sharding,) * 4 + (None,))
            self.eval_step = jax.jit(
                eval_step, in_shardings=(None,) + (batch_sharding,) * 4)
        else:
            self.train_step = jax.jit(train_step)
            self.eval_step = jax.jit(eval_step)

    def _batches(self, which: str, rng: np.random.Generator | None = None):
        adj, fts, lab, mask = self.ds.split(which)
        idx = np.arange(adj.shape[0])
        if rng is not None:
            rng.shuffle(idx)
        b = self.batch_size
        # drop nothing: pad the final batch by repeating (masked out in loss
        # only via node masks; repeated graphs slightly overweight — pad with
        # zero-node graphs instead to stay exact)
        for s in range(0, len(idx), b):
            sel = idx[s:s + b]
            if len(sel) < b:
                pad = b - len(sel)
                yield (
                    np.concatenate([adj[sel], np.zeros((pad,) + adj.shape[1:], adj.dtype)]),
                    np.concatenate([fts[sel], np.zeros((pad,) + fts.shape[1:], fts.dtype)]),
                    np.concatenate([lab[sel], np.zeros((pad,) + lab.shape[1:], lab.dtype)]),
                    np.concatenate([mask[sel], np.zeros((pad,) + mask.shape[1:], mask.dtype)]),
                )
            else:
                yield adj[sel], fts[sel], lab[sel], mask[sel]

    # -- checkpointing (same resilience contract as trainer.py:303-458) ----
    def _ckpt_manager(self):
        return CheckpointManager(pathlib.Path(self.checkpoint_dir)
                                 / f"{self.ds.name}_inductive")

    def _state(self, epoch, best, bad_epochs, best_step) -> dict:
        return {
            "params": self.params, "opt_state": self.opt_state,
            "rng": self._rng, "epoch": jnp.asarray(epoch),
            "best_f1": jnp.asarray(best["f1"]),
            "best_loss": jnp.asarray(best["loss"]),
            "bad_epochs": jnp.asarray(bad_epochs),
            "best_step": jnp.asarray(best_step),
        }

    def restore_latest(self, step: int | None = None):
        mgr = self._ckpt_manager()
        if step is None:
            step = mgr.latest_step()
        if step is None:
            return None
        template = {
            "params": self.params, "opt_state": self.opt_state,
            "rng": jax.random.PRNGKey(0), "epoch": jnp.asarray(0),
            "best_f1": jnp.asarray(0.0), "best_loss": jnp.asarray(0.0),
            "bad_epochs": jnp.asarray(0), "best_step": jnp.asarray(-1),
        }
        return mgr.restore(step, template)

    def fit(self, epochs: int = 20, *, log=None,
            resume: bool = False) -> dict[str, Any]:
        emit = log if log is not None else (
            self.logger.log if self.logger is not None else print)
        history = []
        best = {"f1": -1.0, "loss": np.inf, "params": None, "epoch": -1}
        bad_epochs = 0
        start_epoch = 0
        best_step = -1
        mgr = self._ckpt_manager() if self.checkpoint_dir else None
        if resume and mgr is not None:
            restored = self.restore_latest()
            if restored is not None:
                # deterministic resume (SURVEY.md §5.3): params + opt state
                # + dropout PRNG + early-stop trackers; the per-epoch
                # shuffle stream is derived from (seed, epoch) so the
                # continued run replays the uninterrupted batch order
                self.params = restored["params"]
                self.opt_state = restored["opt_state"]
                self._rng = restored["rng"]
                best["f1"] = float(restored["best_f1"])
                best["loss"] = float(restored["best_loss"])
                bad_epochs = int(restored["bad_epochs"])
                start_epoch = int(restored["epoch"]) + 1
                best_step = int(restored["best_step"])
                if best_step == int(restored["epoch"]):
                    best.update(params=self.params, epoch=best_step)
                elif best_step >= 0:
                    at_best = self.restore_latest(step=best_step)
                    best.update(params=at_best["params"], epoch=best_step)
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            losses = []
            rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
            for adj_b, x_b, y_b, m_b in self._batches("train", rng):
                self._rng, sub = jax.random.split(self._rng)
                self.params, self.opt_state, loss, _ = self.train_step(
                    self.params, self.opt_state,
                    jnp.asarray(adj_b), jnp.asarray(x_b),
                    jnp.asarray(y_b), jnp.asarray(m_b), sub)
                losses.append(float(loss))
            val = self.evaluate("val")
            history.append({"epoch": epoch, "train_loss": float(np.mean(losses)),
                            **{f"val_{k}": v for k, v in val.items()},
                            "time_s": round(time.time() - t0, 3)})
            emit(history[-1])
            # reference-style early stop (ex_acm3025.py:225-240 adapted to
            # micro-F1): keep params on strict best; patience on either
            # metric matching its best
            is_best = (val["micro_f1"] >= best["f1"]
                       and val["loss"] <= best["loss"])
            improved_any = (val["micro_f1"] >= best["f1"]
                            or val["loss"] <= best["loss"])
            if is_best:
                best.update(f1=val["micro_f1"], loss=val["loss"],
                            params=self.params, epoch=epoch)
                best_step = epoch
            bad_epochs = 0 if improved_any else bad_epochs + 1
            saved = False
            if mgr is not None and (is_best or (
                    self.checkpoint_every
                    and (epoch + 1) % self.checkpoint_every == 0)):
                mgr.save(epoch, self._state(epoch, best, bad_epochs, best_step))
                saved = True
            if self.patience is not None and bad_epochs > self.patience:
                break
            if self.guard is not None and self.guard.triggered:
                # preemption (SURVEY.md §5.3): persist full resume state
                # and stop cleanly; fit(resume=True) continues the exact
                # trajectory
                if mgr is not None and not saved:
                    mgr.save(epoch, self._state(epoch, best, bad_epochs,
                                                best_step))
                emit({"preempted_at": epoch})
                return {"preempted": True, "history": history}
        if best["params"] is not None:
            # restore-best-then-test (reference ex_acm3025.py:247)
            self.params = best["params"]
        test = self.evaluate("test")
        return {"history": history, "best_epoch": best["epoch"],
                **{f"test_{k}": v for k, v in test.items()}}

    def evaluate(self, which: str) -> dict[str, float]:
        losses, f1s = [], []
        for adj_b, x_b, y_b, m_b in self._batches(which):
            loss, logits = self.eval_step(
                self.params, jnp.asarray(adj_b), jnp.asarray(x_b),
                jnp.asarray(y_b), jnp.asarray(m_b))
            losses.append(float(loss))
            f1s.append(float(micro_f1(
                logits.reshape(-1, logits.shape[-1]),
                jnp.asarray(y_b).reshape(-1, y_b.shape[-1]),
                jnp.asarray(m_b).reshape(-1))))
        return {"loss": float(np.mean(losses)), "micro_f1": float(np.mean(f1s))}
