"""Mini-batch HAN training via L-hop neighbor-sampled blocks.

The full-graph trainer (train/trainer.py) needs every meta-path adjacency
and the whole feature matrix resident per step — fine up to a few million
edges, impossible for the BASELINE.json synthetic 100M-edge config. This
trainer implements the standard sampled GNN recipe with static shapes:

- each step trains on a fixed-size **seed-node batch**;
- per meta-path, an L-hop bounded-fanout block is sampled around the
  seeds host-side (graph/sampling.sample_subgraph; L = #GAT layers, so
  seed outputs are *exact* message passing over the sampled fanout);
- blocks have **globally static shapes** (block_size × fanout), so the
  jitted step compiles once and every batch reuses it — the EllGraph's
  static treedef metadata is pinned to the nominal capacity, never the
  per-batch edge count;
- seed rows come first in every block, so the per-node semantic attention
  fuses aligned rows across meta-path towers; loss/metrics mask to seed
  rows only.

The reference has no sampling (SURVEY.md §2.3: full neighborhoods, dense
masks) — this subsystem is the scale-out answer it lacks, paired with
edge partitioning (parallel/edge_partition.py) for multi-chip.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from han_jax.datasets.base import HeteroDataset
from han_jax.graph.containers import EllGraph
from han_jax.graph.sampling import sample_subgraph
from han_jax.nn.losses import l2_regularizer, masked_accuracy, masked_softmax_cross_entropy
from han_jax.train.checkpoint import CheckpointManager
from han_jax.train.config import Config
from han_jax.train.trainer import EarlyStopState, MetricLogger, build_model


# checkpoint step id = epoch * stride + batch_cursor (0 = end of epoch,
# stored as (epoch+1)*stride); far above any realistic batches/epoch
_EPOCH_STRIDE = 1_000_000


def _widen_ell(g: EllGraph) -> EllGraph:
    """int16-streamed blocks → the int32 indices the kernels consume."""
    if g.nbr.dtype == jnp.int32:
        return g
    return EllGraph(nbr=g.nbr.astype(jnp.int32), deg=g.deg.astype(jnp.int32),
                    n_nodes=g.n_nodes, n_edges=g.n_edges)


def _resident_gather(tab, nd):
    """Rows ``nd`` of the HBM-resident table; pad slots (nd < 0) → zero.
    Works on (block,) ids and on DP-stacked (S, block) ids alike."""
    real = nd >= 0
    out = tab[jnp.maximum(nd, 0)]
    return jnp.where(real[..., None], out, 0)


def _device_sample_block(row_ptr, col_idx, seeds, valid, key, *,
                         fanout: int, hops: int, block_size: int):
    """L-hop neighbor sampling INSIDE the jitted step.

    The meta-path CSR lives resident in device memory (row_ptr, col_idx
    device arrays); sampling is pure gathers + PRNG, so the steady-state
    training step has no per-batch host sampling and the only host-to-device
    transfer is the (B,) seed ids.

    Block layout (no dedup — static shapes): level 0 = the S seed rows;
    level l+1 = the F sampled in-neighbor slots of every level-l row, in
    slot order, so every ELL neighbor list is a STATIC iota into the next
    level. Nodes with degree <= F take their full neighbor list (take-all
    — exactness when F >= max degree, like the host sampler); larger
    degrees sample F uniformly WITH replacement (GraphSAGE-style; the
    host path samples without replacement — documented difference).

    Returns (nbr (B, F) int32 sentinel=B, deg (B,) int32,
             nodes (B,) int32 global ids pad=-1, n_real_edges scalar).
    """
    s = seeds.shape[0]
    f = fanout
    e_max = col_idx.shape[0] - 1
    level = jnp.where(valid, seeds.astype(jnp.int32), -1)  # (S,)
    nodes_parts = [level]
    nbr_parts = []
    n_edges = jnp.int32(0)
    base_next = s
    for h in range(hops):
        lsz = level.shape[0]
        base_next = base_next + lsz * f
        sv = jnp.maximum(level, 0)
        deg = row_ptr[sv + 1] - row_ptr[sv]                # (L,)
        u = jax.random.uniform(jax.random.fold_in(key, h), (lsz, f))
        # f32 rounding can carry u*deg up to deg itself: clamp to deg-1
        idx_rand = jnp.minimum(jnp.floor(u * deg[:, None]).astype(jnp.int32),
                               jnp.maximum(deg[:, None] - 1, 0))
        idx_seq = jax.lax.broadcasted_iota(jnp.int32, (lsz, f), 1)
        off = jnp.where(deg[:, None] <= f, idx_seq, idx_rand)
        child_valid = (level >= 0)[:, None] & (off < deg[:, None])
        addr = jnp.minimum(row_ptr[sv][:, None] + off, e_max)
        child = jnp.where(child_valid, col_idx[addr].astype(jnp.int32), -1)
        # this level's ELL rows: slot r's children sit at the next level's
        # rows base + r*F + f — a static iota, masked to the sentinel
        slot0 = base_next - lsz * f
        slots = (slot0 + idx_seq
                 + jax.lax.broadcasted_iota(jnp.int32, (lsz, f), 0) * f)
        nbr_parts.append(jnp.where(child_valid, slots, block_size))
        n_edges = n_edges + child_valid.sum(dtype=jnp.int32)
        level = child.reshape(-1)
        nodes_parts.append(level)
    # deepest level + padding rows aggregate nothing
    total = base_next
    nbr = jnp.concatenate(
        nbr_parts + [jnp.full((block_size - (total - level.shape[0]),
                               f), block_size, jnp.int32)], axis=0)
    nodes = jnp.concatenate(
        nodes_parts + [jnp.full((block_size - total,), -1, jnp.int32)])
    deg_out = (nbr < block_size).sum(axis=1).astype(jnp.int32)
    return nbr, deg_out, nodes, n_edges


class SampledTrainer:
    """HAN/GAT training over seed-node batches of a huge heterogeneous graph."""

    def __init__(self, ds: HeteroDataset, cfg: Config, *,
                 batch_size: int = 512, fanout: int = 16,
                 hops: int | None = None, block_size: int | None = None,
                 eval_batches: int | None = None,
                 logger: MetricLogger | None = None,
                 guard=None, resident_features: bool | None = None,
                 sampler: str = "host", steps_per_call: int = 1):
        self.ds = ds
        self.cfg = cfg
        if sampler not in ("host", "device"):
            raise ValueError("sampler must be 'host' or 'device'")
        if steps_per_call > 1 and sampler != "device":
            raise ValueError("steps_per_call > 1 needs sampler='device'")
        self.sampler = sampler
        # device mode: dispatch C training steps per jit call (lax.scan
        # over C packed seed descriptors) — amortizes the per-call
        # dispatch + descriptor-transfer latency; the math is exactly C
        # sequential steps (tests)
        self.steps_per_call = int(steps_per_call)
        # preemption flag polled at batch boundaries (train/preempt.py);
        # None → no signal handling (tests inject via guard.trip())
        self.guard = guard
        self.batch_size = batch_size
        self.fanout = fanout
        self.hops = hops if hops is not None else len(cfg.model.hid_units)
        # default block capacity: seeds + fanout neighbors per hop, padded
        self.block_size = block_size or int(
            batch_size * (fanout + 1) ** self.hops)
        self.eval_batches = eval_batches
        self.logger = logger or MetricLogger(cfg.train.log_file)

        if cfg.model.impl not in ("auto", "ell"):
            raise ValueError("sampled training runs on the ell backend")
        cfg.model.impl = "ell"
        self.model = build_model(ds, cfg)
        self._is_han = cfg.model.arch.startswith("han")
        # self-loops match the full-graph path (reference adj_to_bias adds I,
        # utils/process.py:18-20); graphs stay host-side scipy
        from han_jax.graph.build import with_self_loops

        # one host-side CSR view per meta-path, index dtypes converted ONCE
        # (per-batch astype copies of 100M-edge index arrays dominate the
        # step otherwise)
        self.csrs = [_ScipyCSRView(with_self_loops(a))
                     for a in ds.metapath_adjs]
        self.features = np.ascontiguousarray(ds.features, dtype=np.float32)
        self.labels = np.asarray(ds.labels, dtype=np.float32)
        self.tx = optax.adam(cfg.train.lr)
        # host-side running count of real sampled edges across _make_batch
        # calls (throughput accounting without device round trips)
        self.sampled_edge_count = 0
        # Resident-feature mode (default when the tables fit comfortably in
        # device memory): upload features/labels to the device ONCE and
        # stream only compact per-batch indices; the jitted step gathers
        # the block rows on the device.
        if resident_features is None:
            resident_features = (self.features.nbytes
                                 + self.labels.nbytes) <= (2 << 30)
        if sampler == "device" and not resident_features:
            raise ValueError("sampler='device' needs resident features")
        self.resident = bool(resident_features)
        if self.resident:
            mesh = getattr(self, "mesh", None)
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec

                sh = NamedSharding(mesh, PartitionSpec())  # replicated
                self._fts_dev = jax.device_put(self.features, sh)
                self._lbl_dev = jax.device_put(self.labels, sh)
            else:
                self._fts_dev = jax.device_put(self.features)
                self._lbl_dev = jax.device_put(self.labels)
        if sampler == "device":
            # no-dedup block layout: levels S, S·F, …, S·F^hops must fit
            need = sum(batch_size * fanout ** h for h in range(self.hops + 1))
            if need > self.block_size:
                raise ValueError(
                    f"device sampler needs block_size >= {need}")
            if any(c.n_edges >= 2 ** 31 for c in self.csrs):
                raise ValueError("device sampler: edge count exceeds int32")
            # meta-path CSRs resident in HBM: sampling runs inside the
            # jitted step (_device_sample_block); per-batch H2D = seed ids
            self._csr_dev = [
                (jax.device_put(np.asarray(c.row_ptr, np.int32)),
                 jax.device_put(np.asarray(c.col_idx, np.int32)))
                for c in self.csrs]
        self._build_steps()

    # -- batch assembly ----------------------------------------------------
    def _make_batch(self, seeds: np.ndarray, valid: np.ndarray,
                    sample_seed: int, *, fanout: int | None = None,
                    block_size: int | None = None):
        """One seed batch → the jitted step's batch arguments.

        Device-sampler mode returns a tiny descriptor (seed ids, valid
        mask, sampling key) — the block is assembled INSIDE the step from
        the HBM-resident CSR. Custom fanout/block_size requests (exact
        eval) and host mode build the block host-side."""
        if (self.sampler == "device" and fanout is None
                and block_size is None):
            # ONE packed int32 buffer (seeds | valid | sample seed), so the
            # descriptor is a single host-to-device transfer; the step
            # unpacks it (and derives the PRNG key from the seed) in-jit
            packed = np.empty(2 * seeds.shape[0] + 1, np.int32)
            packed[: seeds.shape[0]] = seeds.astype(np.int32)
            packed[seeds.shape[0]: 2 * seeds.shape[0]] = valid
            packed[-1] = sample_seed
            return (packed, None, None, None)
        return self._make_batch_host(seeds, valid, sample_seed,
                                     fanout=fanout, block_size=block_size)

    def _make_batch_host(self, seeds: np.ndarray, valid: np.ndarray,
                         sample_seed: int, *, fanout: int | None = None,
                         block_size: int | None = None):
        """Host-sampled blocks → (graphs, xs, labels, mask) device args.

        ``valid`` masks padded seed slots (eval tail batches). Static
        shapes: every output has the same shape for every batch (a distinct
        fanout/block_size — e.g. exact eval — compiles its own step once).
        """
        fanout = fanout if fanout is not None else self.fanout
        block_size = block_size if block_size is not None else self.block_size
        # block-local neighbor ids fit int16 at typical block sizes; they are
        # widened to int32 on device inside the jitted step, halving the
        # per-batch index transfer
        idx_dt = np.int16 if block_size + 1 < 2 ** 15 else np.int32
        graphs, xs = [], []
        lbl = (None if self.resident
               else np.zeros((block_size, self.labels.shape[1]), np.float32))
        mask = np.zeros(block_size, np.float32)
        for p, csr in enumerate(self.csrs):
            sb = sample_subgraph(
                csr, seeds, fanout=fanout, hops=self.hops,
                block_size=block_size, seed=sample_seed * 7919 + p)
            self.sampled_edge_count += int((sb.nbr < block_size).sum())
            deg = (sb.nbr < block_size).sum(axis=1).astype(idx_dt)
            # pin static metadata to capacity so the jitted step's treedef
            # (and hence the compiled program) is identical for every batch
            graphs.append(EllGraph(nbr=jnp.asarray(sb.nbr.astype(idx_dt)),
                                   deg=jnp.asarray(deg),
                                   n_nodes=block_size,
                                   n_edges=block_size * fanout))
            if self.resident:
                # stream global node ids only; the step gathers rows from
                # the HBM-resident tables (pad slots are -1)
                xs.append(jnp.asarray(sb.nodes.astype(np.int32)))
            else:
                xs.append(jnp.asarray(sb.gather_features(self.features)))
            if p == 0:
                mask[: seeds.shape[0]] = valid.astype(np.float32)
                if not self.resident:
                    real = sb.nodes >= 0
                    lbl[real] = self.labels[sb.nodes[real]]
        if not self.resident:
            lbl = jnp.asarray(lbl)
        return graphs, xs, lbl, jnp.asarray(mask)

    # -- jitted steps ------------------------------------------------------
    def _apply(self, params, graphs, xs, *, deterministic, rng=None):
        # direct (out-of-jit) callers may hand over raw resident-mode blocks
        # (compact index dtypes, id-valued xs) — materialize them here; the
        # jitted steps materialize in prep() with the tables as jit args
        graphs = [_widen_ell(g) for g in graphs]
        if (self.resident and xs
                and jnp.issubdtype(jnp.asarray(xs[0]).dtype, jnp.integer)):
            xs = [_resident_gather(self._fts_dev, jnp.asarray(nd)) for nd in xs]
        args = (graphs, xs) if self._is_han else (graphs[0], xs[0])
        kwargs: dict[str, Any] = {"deterministic": deterministic}
        if rng is not None:
            kwargs["rngs"] = {"dropout": rng}
        out = self.model.apply(params, *args, **kwargs)
        return (out[0], out[1]) if self._is_han else (out, out)

    def _build_steps(self):
        l2c = self.cfg.train.l2_coef

        def prep(graphs, xs, labels, fts, lab_tab):
            # device-side batch materialization: widen compact index dtypes;
            # in resident mode gather block features/labels from the
            # HBM-resident tables (xs carries global node ids, pad = -1)
            graphs = [_widen_ell(g) for g in graphs]
            if fts is not None:
                labels = _resident_gather(lab_tab, xs[0])
                xs = [_resident_gather(fts, nd) for nd in xs]
            return graphs, xs, labels

        def train_step(params, opt_state, rng, graphs, xs, labels, mask,
                       fts=None, lab_tab=None):
            graphs, xs, labels = prep(graphs, xs, labels, fts, lab_tab)
            rng, sub = jax.random.split(rng)

            def loss_fn(p):
                logits, _ = self._apply(p, graphs, xs, deterministic=False, rng=sub)
                return (masked_softmax_cross_entropy(logits, labels, mask)
                        + l2_regularizer(p, l2c)), logits

            (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = self.tx.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return params, opt_state, rng, loss, masked_accuracy(logits, labels, mask)

        def eval_step(params, graphs, xs, labels, mask, fts=None, lab_tab=None):
            graphs, xs, labels = prep(graphs, xs, labels, fts, lab_tab)
            logits, embed = self._apply(params, graphs, xs, deterministic=True)
            logp = jax.nn.log_softmax(logits, axis=-1)
            loss_i = -jnp.sum(labels * logp, axis=-1)
            correct = (jnp.argmax(logits, -1) == jnp.argmax(labels, -1)).astype(jnp.float32)
            return (jnp.sum(loss_i * mask), jnp.sum(correct * mask),
                    jnp.sum(mask), embed)

        jt, je = jax.jit(train_step), jax.jit(eval_step)

        if self.sampler == "device":
            # sampling inside the step: block descriptors in, blocks built
            # from the HBM-resident CSRs as gathers (+ static-iota ELL).
            # The no-dedup layout is a TREE, so the blocks carry static
            # parent maps and dispatch to the scatter-free tree_ell
            # backward (ops/tree_ell.py)
            from han_jax.graph.containers import TreeEllGraph
            from han_jax.ops.tree_ell import tree_parent_maps

            fanout, hops, block = self.fanout, self.hops, self.block_size
            pr_np, ps_np = tree_parent_maps(self.batch_size, fanout, hops,
                                            block)
            pr_c, ps_c = jnp.asarray(pr_np), jnp.asarray(ps_np)

            def build_blocks(seeds, valid, skey, csrs):
                graphs, xs, n_edges = [], [], jnp.int32(0)
                for p, (rp, ci) in enumerate(csrs):
                    nbr, deg, nodes, ne = _device_sample_block(
                        rp, ci, seeds, valid, jax.random.fold_in(skey, p),
                        fanout=fanout, hops=hops, block_size=block)
                    graphs.append(TreeEllGraph(
                        nbr=nbr, deg=deg, n_nodes=block,
                        n_edges=block * fanout,
                        parent_row=pr_c, parent_slot=ps_c))
                    xs.append(nodes)
                    n_edges = n_edges + ne
                mask = jnp.zeros(block, jnp.float32).at[
                    : seeds.shape[0]].set(valid.astype(jnp.float32))
                return graphs, xs, mask, n_edges

            def unpack(packed):
                s = (packed.shape[0] - 1) // 2
                return (packed[:s], packed[s:2 * s] != 0,
                        jax.random.PRNGKey(packed[-1]))

            def dev_train_step(params, opt_state, rng, packed,
                               fts, lab_tab, csrs):
                seeds, valid, skey = unpack(packed)
                graphs, xs, mask, ne = build_blocks(seeds, valid, skey, csrs)
                out = train_step(params, opt_state, rng, graphs, xs, None,
                                 mask, fts, lab_tab)
                return out + (ne,)

            def dev_eval_step(params, packed, fts, lab_tab, csrs):
                seeds, valid, skey = unpack(packed)
                graphs, xs, mask, ne = build_blocks(seeds, valid, skey, csrs)
                return eval_step(params, graphs, xs, None, mask, fts,
                                 lab_tab) + (ne,)

            def dev_train_chunk(params, opt_state, rng, packs,
                                fts, lab_tab, csrs):
                # C sequential steps in ONE dispatch (lax.scan): identical
                # math to C separate dev_train_step calls
                def body(carry, packed):
                    p, o, r = carry
                    p, o, r, loss, acc, ne = dev_train_step(
                        p, o, r, packed, fts, lab_tab, csrs)
                    return (p, o, r), (loss, acc, ne)

                (params, opt_state, rng), (losses, accs, nes) = jax.lax.scan(
                    body, (params, opt_state, rng), packs)
                return params, opt_state, rng, losses, accs, nes.sum()

            djt, dje = jax.jit(dev_train_step), jax.jit(dev_eval_step)
            djc = jax.jit(dev_train_chunk)
            self._pending_edge_counts = []

            def tr(p, o, r, *batch):
                if isinstance(batch[0], (list, tuple)):  # host-built block
                    return jt(p, o, r, *batch, self._fts_dev, self._lbl_dev)
                if getattr(batch[0], "ndim", 1) == 2:  # stacked descriptors
                    p2, o2, r2, losses, accs, ne = djc(
                        p, o, r, batch[0], self._fts_dev, self._lbl_dev,
                        self._csr_dev)
                    self._pending_edge_counts.append(ne)
                    return p2, o2, r2, losses, accs
                *out, ne = djt(p, o, r, batch[0], self._fts_dev,
                               self._lbl_dev, self._csr_dev)
                self._pending_edge_counts.append(ne)
                return tuple(out)

            def ev(p, *batch):
                if isinstance(batch[0], (list, tuple)):
                    return je(p, *batch, self._fts_dev, self._lbl_dev)
                *out, ne = dje(p, batch[0], self._fts_dev,
                               self._lbl_dev, self._csr_dev)
                self._pending_edge_counts.append(ne)
                return tuple(out)

            self._train_step, self._eval_step = tr, ev
        elif self.resident:
            # the resident tables ride as jit ARGUMENTS, not program
            # constants
            self._train_step = lambda p, o, r, g, x, l, m: jt(
                p, o, r, g, x, l, m, self._fts_dev, self._lbl_dev)
            self._eval_step = lambda p, g, x, l, m: je(
                p, g, x, l, m, self._fts_dev, self._lbl_dev)
        else:
            self._train_step, self._eval_step = jt, je

    def flush_sampled_edges(self) -> int:
        """Fold the device-side real-edge counters of device-sampled steps
        into ``sampled_edge_count`` (one device sync)."""
        pend = getattr(self, "_pending_edge_counts", None)
        if pend:
            total = pend[0]
            for v in pend[1:]:
                total = total + v
            self.sampled_edge_count += int(total)
            self._pending_edge_counts = []
        return self.sampled_edge_count

    def _prefetched_indexed(self, indexed_iter, sample_seed_fn):
        """One-ahead pipelined batch assembly: the NEXT block is sampled on a
        worker thread while the device runs the CURRENT step (host sampling
        and device compute overlap — the standard sampled-GNN pipeline).
        ``indexed_iter`` yields (batch_index, (seeds, valid)); the true
        index keys the deterministic sample seed even when resume skips a
        prefix of the epoch."""
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = None
            for bi, (seeds, valid) in indexed_iter:
                nxt = (bi, pool.submit(self._make_batch, seeds, valid,
                                       sample_seed_fn(bi)))
                if fut is not None:
                    yield fut[0], fut[1].result()
                fut = nxt
            if fut is not None:
                yield fut[0], fut[1].result()

    def _chunked(self, indexed_iter):
        """Group device-mode descriptors into steps_per_call stacks; yields
        (last_batch_index, (stacked_descriptors, None, None, None)). The
        tail (< steps_per_call batches) is yielded as SINGLE descriptors —
        reusing the per-step program instead of compiling a distinct
        shorter-chunk program."""
        buf, last_bi, bis = [], -1, []
        for bi, (packed, _, _, _) in indexed_iter:
            buf.append(np.asarray(packed))
            bis.append(bi)
            last_bi = bi
            if len(buf) == self.steps_per_call:
                yield last_bi, (np.stack(buf), None, None, None)
                buf, bis = [], []
        for bi, packed in zip(bis, buf):
            yield bi, (packed, None, None, None)

    # -- batch iteration ---------------------------------------------------
    def _seed_batches(self, idx: np.ndarray, *, shuffle: bool, epoch: int):
        rng = np.random.default_rng(self.cfg.train.seed * 1_000_003 + epoch)
        order = rng.permutation(idx) if shuffle else idx
        b = self.batch_size
        for i in range(0, order.shape[0], b):
            chunk = order[i : i + b]
            valid = np.ones(chunk.shape[0], bool)
            if chunk.shape[0] < b:  # pad tail batch, mask the padding out
                # repeat an in-batch seed (NOT node 0): with duplicate seeds
                # the sampler attaches neighbors to the first occurrence, so
                # the real (mask=1) row keeps its edges and only the masked
                # pad rows are edgeless
                pad = np.full(b - chunk.shape[0], chunk[0], chunk.dtype)
                valid = np.concatenate([valid, np.zeros(pad.shape[0], bool)])
                chunk = np.concatenate([chunk, pad])
            yield chunk.astype(np.int32), valid

    def _init_params_from(self, rng, graphs, xs):
        if not isinstance(graphs, (list, tuple)):
            # device-sampler packed descriptor (possibly a stacked chunk):
            # shapes at apply time equal a host-built block's — init
            # through one host block
            packed = np.asarray(graphs)
            if packed.ndim == 2:
                packed = packed[0]
            s = (packed.shape[0] - 1) // 2
            graphs, xs, _, _ = self._make_batch_host(
                packed[:s], packed[s:2 * s] != 0, sample_seed=0)
        # init must see the shapes/dtypes apply sees in-jit: int32 indices
        # and materialized features (host-side here — no extra compiles)
        graphs = [EllGraph(
            nbr=jnp.asarray(np.asarray(g.nbr, dtype=np.int32)),
            deg=jnp.asarray(np.asarray(g.deg, dtype=np.int32)),
            n_nodes=g.n_nodes, n_edges=g.n_edges) for g in graphs]
        if self.resident:
            xs_m = []
            for nd in xs:
                nd = np.asarray(nd)
                x = self.features[np.maximum(nd, 0)].copy()
                x[nd < 0] = 0
                xs_m.append(jnp.asarray(x))
            xs = xs_m
        args = (graphs, xs) if self._is_han else (graphs[0], xs[0])
        return self.model.init(rng, *args)

    def exact_eval_plan(self, idx: np.ndarray | None = None,
                        max_block: int = 4_000_000):
        """(fanout, block_size) for EXACT evaluation of the nodes in
        ``idx``: block_size = the largest TRUE L-hop reachable set of any
        eval batch (computed host-side from the CSRs), fanout = the max
        in-degree among nodes whose neighborhoods actually get expanded
        (BFS depth < L). Returns None when any batch's true block exceeds
        ``max_block`` — callers fall back to sampled eval with a logged
        flag.

        Sizing blocks by batch·deg_max^hops would let ONE hub node
        anywhere in the graph forfeit exact eval for the whole graph —
        exactly wrong for the skewed graphs the
        sampled trainer exists for. ``idx=None`` keeps that conservative
        global worst-case bound (no batch structure to measure)."""
        if idx is None:
            deg_max = max(
                int(np.diff(c.row_ptr).max()) if c.n_edges else 1
                for c in self.csrs)
            block = self.batch_size
            width = self.batch_size
            for _ in range(self.hops):
                width = width * deg_max  # worst-case frontier growth
                block = block + min(width, max_block)
                if block > max_block:
                    return None
            return deg_max, int(block)

        fanout_need = 1
        block_need = self.batch_size
        for seeds, _valid in self._seed_batches(np.asarray(idx),
                                                shuffle=False, epoch=0):
            for csr in self.csrs:
                u_seeds = np.unique(seeds.astype(np.int64))
                reached = u_seeds
                frontier = reached
                # the block keeps one row per SEED SLOT (duplicate/padded
                # seeds occupy slots without adding reachable nodes), plus
                # one row per non-seed reached node
                slack = self.batch_size - u_seeds.size
                for _hop in range(self.hops):
                    # expanded nodes need their FULL in-neighbor list to fit
                    # the ELL width
                    degs = np.diff(csr.row_ptr)[frontier]
                    if degs.size:
                        fanout_need = max(fanout_need, int(degs.max()))
                    cols = _gather_neighbors(csr, frontier)
                    frontier = np.setdiff1d(np.unique(cols), reached,
                                            assume_unique=True)
                    reached = np.union1d(reached, frontier)
                    if reached.size + slack > max_block:
                        return None
                block_need = max(block_need, int(reached.size) + slack)
        if block_need > max_block:
            return None
        return fanout_need, int(block_need)

    def evaluate(self, params, idx: np.ndarray, *, epoch: int = 0,
                 exact: bool = False):
        """Masked loss/accuracy over ``idx``. Default: SAMPLED blocks —
        every node in ``idx`` is scored exactly once, but its logits see
        only the bounded-fanout sampled neighborhood (deterministic in
        ``epoch``), the standard trade-off for >HBM graphs.

        ``exact=True``: full-neighborhood blocks (fanout = max degree), so
        the metric equals full-graph evaluation
        (tests/test_sampled_trainer.py::test_exact_eval_matches_full_graph)
        — falls back to sampled with an ``exact_eval_unavailable`` log line
        when full blocks exceed capacity."""
        fanout = block = None
        if exact:
            plan = self.exact_eval_plan(np.asarray(idx))
            if plan is None:
                self.logger.log({"exact_eval_unavailable":
                                 "full-neighborhood blocks exceed capacity",
                                 "fallback": "sampled"})
            else:
                fanout, block = plan
        tot_l = tot_c = tot_n = 0.0
        for bi, (seeds, valid) in enumerate(
                self._seed_batches(idx, shuffle=False, epoch=0)):
            if self.eval_batches is not None and bi >= self.eval_batches:
                break
            graphs, xs, lbl, mask = self._make_batch(
                seeds, valid, sample_seed=10_000_019 + epoch,
                fanout=fanout, block_size=block)
            l, c, n, _ = self._eval_step(params, graphs, xs, lbl, mask)
            tot_l += float(l); tot_c += float(c); tot_n += float(n)
        tot_n = max(tot_n, 1.0)
        return tot_l / tot_n, tot_c / tot_n

    # -- checkpointing (SURVEY.md §5.3-5.4) ---------
    # The sampled trainer drives the multi-hour 100M-edge runs, so it gets
    # the full resume state INCLUDING a mid-epoch batch cursor: the
    # batch order is deterministic in (seed, epoch), so a run preempted
    # after batch b resumes by replaying the same permutation and skipping
    # the first b batches — the continued trajectory is exact.
    def _ckpt_manager(self):
        import pathlib

        return CheckpointManager(pathlib.Path(self.cfg.train.checkpoint_dir)
                                 / f"{self.ds.name}_sampled")

    def _state_template(self, params, opt_state):
        return {
            "params": params, "opt_state": opt_state,
            "step_rng": jax.random.PRNGKey(0),
            "epoch": jnp.asarray(0), "cursor": jnp.asarray(0),
            "loss_sum": jnp.asarray(0.0), "acc_sum": jnp.asarray(0.0),
            "n_batches": jnp.asarray(0),
            "best_val_loss": jnp.asarray(0.0), "best_val_acc": jnp.asarray(0.0),
            "bad_epochs": jnp.asarray(0), "best_step": jnp.asarray(-1),
        }

    def _save(self, mgr, step, **state):
        state = {k: (v if k in ("params", "opt_state", "step_rng")
                     else jnp.asarray(v)) for k, v in state.items()}
        mgr.save(step, state)

    def restore_latest(self, params, opt_state, step: int | None = None):
        mgr = self._ckpt_manager()
        if step is None:
            step = mgr.latest_step()
        if step is None:
            return None
        return mgr.restore(step, self._state_template(params, opt_state))

    def time_steps(self, n_steps: int, *, epoch: int = 0) -> dict[str, Any]:
        """Train from fresh params over one epoch's shuffled batches as
        ``fit`` does (one-ahead prefetch, ``steps_per_call`` chunks): one
        warm-up dispatch that compiles, then ``n_steps`` timed steps, each
        dispatch waited on with ``block_until_ready``. Returns the warm-up
        time, per-dispatch wall times (s), steps run, real sampled edges
        of the timed steps and the last loss."""
        train_idx = np.where(self.ds.train_mask)[0]
        batches = self._prefetched_indexed(
            enumerate(self._seed_batches(train_idx, shuffle=True, epoch=epoch)),
            lambda bi: epoch * 65_537 + bi)
        if self.steps_per_call > 1:
            batches = self._chunked(batches)
        _, first = next(batches)
        params = self._init_params_from(
            jax.random.PRNGKey(self.cfg.train.seed), first[0], first[1])
        opt_state = self.tx.init(params)
        rng = jax.random.PRNGKey(self.cfg.train.seed + 1)
        t0 = time.perf_counter()
        params, opt_state, rng, loss, _ = self._train_step(
            params, opt_state, rng, *first)
        jax.block_until_ready(loss)
        first_s = time.perf_counter() - t0
        edges0 = self.flush_sampled_edges()
        times, steps = [], 0
        for _, batch in batches:
            if steps >= n_steps:
                break
            t0 = time.perf_counter()
            params, opt_state, rng, loss, _ = self._train_step(
                params, opt_state, rng, *batch)
            jax.block_until_ready(loss)
            times.append(time.perf_counter() - t0)
            steps += int(np.shape(loss)[0]) if np.ndim(loss) else 1
        batches.close()
        return {"first_step_s": first_s, "step_s": times, "steps": steps,
                "sampled_edges": self.flush_sampled_edges() - edges0,
                "loss": float(np.asarray(loss).ravel()[-1])}

    def fit(self, *, resume: bool = False) -> dict[str, Any]:
        cfg = self.cfg.train
        rng = jax.random.PRNGKey(cfg.seed)
        init_graphs, init_xs, _, _ = self._make_batch(
            *next(self._seed_batches(np.where(self.ds.train_mask)[0],
                                     shuffle=False, epoch=0)), sample_seed=0)
        params = self._init_params_from(rng, init_graphs, init_xs)
        opt_state = self.tx.init(params)
        step_rng = jax.random.PRNGKey(cfg.seed + 1)
        es = EarlyStopState()
        best = {"params": params, "epoch": -1}
        best_step = -1
        mgr = self._ckpt_manager()
        start_epoch, start_cursor = 0, 0
        carry_sums = (0.0, 0.0, 0)
        if resume:
            restored = self.restore_latest(params, opt_state)
            if restored is not None:
                params = restored["params"]
                opt_state = restored["opt_state"]
                step_rng = restored["step_rng"]
                es.best_val_loss = float(restored["best_val_loss"])
                es.best_val_acc = float(restored["best_val_acc"])
                es.bad_epochs = int(restored["bad_epochs"])
                start_cursor = int(restored["cursor"])
                start_epoch = int(restored["epoch"]) + (start_cursor == 0)
                carry_sums = (float(restored["loss_sum"]),
                              float(restored["acc_sum"]),
                              int(restored["n_batches"]))
                best_step = int(restored["best_step"])
                if best_step >= 0:
                    at_best = self.restore_latest(params, opt_state,
                                                  step=best_step)
                    best = {"params": at_best["params"],
                            "epoch": best_step // _EPOCH_STRIDE - 1}
        train_idx = np.where(self.ds.train_mask)[0]
        val_idx = np.where(self.ds.val_mask)[0]
        t_start = time.time()

        preempted = False
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            loss_sum, acc_sum, n_done = (carry_sums if epoch == start_epoch
                                         and start_cursor else (0.0, 0.0, 0))
            skip = start_cursor if epoch == start_epoch else 0
            batches = ((bi, b) for bi, b in enumerate(
                self._seed_batches(train_idx, shuffle=True, epoch=epoch))
                if bi >= skip)
            step_iter = self._prefetched_indexed(
                batches, lambda bi: epoch * 65_537 + bi)
            if self.steps_per_call > 1:
                step_iter = self._chunked(step_iter)
            for bi, (graphs, xs, lbl, mask) in step_iter:
                params, opt_state, step_rng, loss, acc = self._train_step(
                    params, opt_state, step_rng, graphs, xs, lbl, mask)
                if np.ndim(loss):  # chunked dispatch: per-step vectors
                    loss_sum += float(jnp.sum(loss))
                    acc_sum += float(jnp.sum(acc))
                    n_done += int(np.shape(loss)[0])
                else:
                    loss_sum += float(loss); acc_sum += float(acc); n_done += 1
                if self.guard is not None and self.guard.triggered:
                    # preemption: full resume state incl. the batch cursor
                    self._save(mgr, epoch * _EPOCH_STRIDE + bi + 1,
                               params=params, opt_state=opt_state,
                               step_rng=step_rng, epoch=epoch, cursor=bi + 1,
                               loss_sum=loss_sum, acc_sum=acc_sum,
                               n_batches=n_done,
                               best_val_loss=es.best_val_loss,
                               best_val_acc=es.best_val_acc,
                               bad_epochs=es.bad_epochs, best_step=best_step)
                    self.logger.log({"preempted_at": [epoch, bi + 1]})
                    preempted = True
                    break
            if preempted:
                break
            # fold this epoch's device-side edge counters into
            # sampled_edge_count (one sync per epoch, bounded list)
            self.flush_sampled_edges()
            vl_loss, vl_acc = self.evaluate(params, val_idx, epoch=epoch)
            self.logger.log({
                "epoch": epoch, "train_loss": loss_sum / max(n_done, 1),
                "train_acc": acc_sum / max(n_done, 1), "val_loss": vl_loss,
                "val_acc": vl_acc, "epoch_time_s": round(time.time() - t0, 4),
            })
            ckpt, _ = es.update(vl_loss, vl_acc)
            periodic = cfg.checkpoint_every and \
                (epoch + 1) % cfg.checkpoint_every == 0
            if ckpt:
                best = {"params": params, "epoch": epoch}
                best_step = (epoch + 1) * _EPOCH_STRIDE
            if ckpt or periodic:
                self._save(mgr, (epoch + 1) * _EPOCH_STRIDE,
                           params=params, opt_state=opt_state,
                           step_rng=step_rng, epoch=epoch, cursor=0,
                           loss_sum=0.0, acc_sum=0.0, n_batches=0,
                           best_val_loss=es.best_val_loss,
                           best_val_acc=es.best_val_acc,
                           bad_epochs=es.bad_epochs, best_step=best_step)
            if es.bad_epochs >= cfg.patience:
                break
        if preempted:
            self.final_params = params
            return {"preempted": True, "train_time_s": time.time() - t_start}

        params = best["params"]
        ts_loss, ts_acc = self.evaluate(
            params, np.where(self.ds.test_mask)[0], epoch=0)
        self.final_params = params
        return {"test_loss": ts_loss, "test_acc": ts_acc,
                "best_epoch": best["epoch"],
                "train_time_s": time.time() - t_start}


def _gather_neighbors(csr, nodes: np.ndarray) -> np.ndarray:
    """All in-neighbors of ``nodes`` (concatenated, with duplicates) from a
    CSR view — vectorized range-gather, O(total neighbor count)."""
    starts = csr.row_ptr[nodes]
    counts = csr.row_ptr[nodes + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=csr.col_idx.dtype)
    cum = np.concatenate([[0], np.cumsum(counts)])
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(cum[:-1], counts) + np.repeat(starts, counts))
    return csr.col_idx[pos]


class _ScipyCSRView:
    """Duck-typed CSRGraph view over a scipy matrix (no device transfer;
    index dtypes normalized once at construction)."""

    def __init__(self, m):
        m = m.tocsr()
        self.row_ptr = np.ascontiguousarray(m.indptr, np.int64)
        self.col_idx = np.ascontiguousarray(m.indices, np.int32)
        self.n_nodes = m.shape[0]
        self.n_edges = int(m.nnz)


class DPSampledTrainer(SampledTrainer):
    """Sampled training data-parallel over the mesh ``graph`` axis.

    The seed batch is split into one sub-block per graph-axis shard; every
    leaf is stacked to ``(S, ...)`` and device_put with a
    ``P('graph', ...)`` sharding, so XLA SPMD runs each shard's block on
    its own device and psums the (replicated-parameter) gradients — DP
    for sampled GNN training (SURVEY.md §2.3 row 1). Loss and
    accuracy are exact global masked means (weighted sums across shards),
    so an S-way step equals the single-device step on the same seeds
    (tests/test_sampled_trainer.py)."""

    def __init__(self, ds: HeteroDataset, cfg: Config, *, mesh,
                 batch_size: int = 512, fanout: int = 16,
                 hops: int | None = None, block_size: int | None = None,
                 **kw):
        from han_jax.parallel.mesh import GRAPH_AXIS

        if kw.get("sampler", "host") == "device":
            raise NotImplementedError(
                "DPSampledTrainer shards host-built blocks; the device "
                "sampler is single-chip (its DP composition would sample "
                "inside the sharded step — not wired up)")
        self.mesh = mesh
        self.n_shards = int(mesh.shape[GRAPH_AXIS])
        if batch_size % self.n_shards:
            raise ValueError(
                f"batch_size {batch_size} not divisible by {self.n_shards} shards")
        per_shard = batch_size // self.n_shards
        h = hops if hops is not None else len(cfg.model.hid_units)
        block_size = block_size or int(per_shard * (fanout + 1) ** h)
        super().__init__(ds, cfg, batch_size=batch_size, fanout=fanout,
                         hops=hops, block_size=block_size, **kw)

    def _make_batch(self, seeds: np.ndarray, valid: np.ndarray,
                    sample_seed: int, *, fanout: int | None = None,
                    block_size: int | None = None):
        from jax.sharding import NamedSharding, PartitionSpec
        from han_jax.parallel.mesh import GRAPH_AXIS

        s = self.n_shards
        seed_groups = seeds.reshape(s, -1)
        valid_groups = valid.reshape(s, -1)
        parts = [super(DPSampledTrainer, self)._make_batch(
                     seed_groups[i], valid_groups[i], sample_seed * s + i,
                     fanout=fanout, block_size=block_size)
                 for i in range(s)]
        stacked = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *parts)
        return jax.device_put(
            stacked, NamedSharding(self.mesh, PartitionSpec(GRAPH_AXIS)))

    def _init_params_from(self, rng, graphs, xs):
        from jax.sharding import NamedSharding, PartitionSpec

        # init on shard 0's (unstacked) block; replicate over the mesh
        g0 = jax.tree_util.tree_map(lambda a: a[0], graphs)
        x0 = [x[0] for x in xs]
        params = super()._init_params_from(rng, g0, x0)
        return jax.device_put(params, NamedSharding(self.mesh, PartitionSpec()))

    def _build_steps(self):
        l2c = self.cfg.train.l2_coef
        s = self.n_shards

        def fwd(params, graphs, xs, rng, deterministic):
            args = (graphs, xs) if self._is_han else (graphs[0], xs[0])
            kwargs: dict[str, Any] = {"deterministic": deterministic}
            if rng is not None:
                kwargs["rngs"] = {"dropout": rng}
            out = self.model.apply(params, *args, **kwargs)
            return (out[0], out[1]) if self._is_han else (out, out)

        def global_masked(logits, labels, mask):
            logp = jax.nn.log_softmax(logits, axis=-1)
            loss_i = -jnp.sum(labels * logp, axis=-1)          # (S, block)
            correct = (jnp.argmax(logits, -1) == jnp.argmax(labels, -1)
                       ).astype(jnp.float32)
            n = jnp.maximum(jnp.sum(mask), 1.0)
            return jnp.sum(loss_i * mask) / n, jnp.sum(correct * mask) / n

        def prep(graphs, xs, labels, fts, lab_tab):
            # (S, block) leaves: widen index dtypes; resident mode gathers
            # the stacked blocks from the replicated HBM tables
            graphs = [_widen_ell(g) for g in graphs]
            if fts is not None:
                labels = _resident_gather(lab_tab, xs[0])   # (S, block, C)
                xs = [_resident_gather(fts, nd) for nd in xs]
            return graphs, xs, labels

        def train_step(params, opt_state, rng, graphs, xs, labels, mask,
                       fts=None, lab_tab=None):
            graphs, xs, labels = prep(graphs, xs, labels, fts, lab_tab)
            rng, sub = jax.random.split(rng)
            subs = jax.random.split(sub, s)  # per-shard dropout streams

            def loss_fn(p):
                logits, _ = jax.vmap(
                    lambda g, x, r: fwd(p, g, x, r, False))(graphs, xs, subs)
                loss, acc = global_masked(logits, labels, mask)
                return loss + l2_regularizer(p, l2c), acc

            (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = self.tx.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return params, opt_state, rng, loss, acc

        def eval_step(params, graphs, xs, labels, mask, fts=None, lab_tab=None):
            graphs, xs, labels = prep(graphs, xs, labels, fts, lab_tab)
            logits, embed = jax.vmap(
                lambda g, x: fwd(params, g, x, None, True))(graphs, xs)
            logp = jax.nn.log_softmax(logits, axis=-1)
            loss_i = -jnp.sum(labels * logp, axis=-1)
            correct = (jnp.argmax(logits, -1) == jnp.argmax(labels, -1)
                       ).astype(jnp.float32)
            return (jnp.sum(loss_i * mask), jnp.sum(correct * mask),
                    jnp.sum(mask), embed)

        jt, je = jax.jit(train_step), jax.jit(eval_step)
        if self.resident:
            self._train_step = lambda p, o, r, g, x, l, m: jt(
                p, o, r, g, x, l, m, self._fts_dev, self._lbl_dev)
            self._eval_step = lambda p, g, x, l, m: je(
                p, g, x, l, m, self._fts_dev, self._lbl_dev)
        else:
            self._train_step, self._eval_step = jt, je
