"""Ring halo-exchange attention: feature blocks rotate between devices instead of
being replicated.

``partitioned_attention`` (shard_attn.py) replicates all source features
along the graph axis — an all-gather of the (N, K, D) array at every layer.
This module is the memory-scalable variant (the ring-attention analog,
SURVEY.md §5.7): node features stay sharded P('graph'); each of S ring
steps a shard processes the edge *bucket* whose sources live in the block
it currently holds, then passes the block to its ring neighbor
(``ppermute``). Peak per-device feature memory is O(N/S · K · D) instead of
O(N · K · D), and each transfer goes to one ring neighbor.

Softmax statistics need no features: the per-head logit terms (N, K) are
tiny and stay replicated, so coefficients are exact (not approximated) —
two cheap stat passes over the edge buckets, then the S-step ring for the
expensive aggregation.

Edge buckets come from ``partition_csr_2d``: edges grouped by
(destination shard, source shard) with one static bucket capacity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from han_jax.graph.containers import CSRGraph, MASK_VALUE
from han_jax.ops.attention import leaky_relu
from han_jax.parallel.mesh import GRAPH_AXIS, HEAD_AXIS


@dataclasses.dataclass(frozen=True)
class PartitionedCSR2D:
    """Edges bucketed by (dst shard, src shard); uniform node blocks.

    row_local:  int32[S, S, E2] destination row within dst shard, pad = n_loc
    col_local:  int32[S, S, E2] source row within src shard, pad = n_loc
    col_global: int32[S, S, E2] global source id, pad = n_nodes
    """

    row_local: jax.Array
    col_local: jax.Array
    col_global: jax.Array
    n_nodes: int
    n_loc: int
    n_edges: int
    n_shards: int

    @property
    def e_bucket(self) -> int:
        return int(self.row_local.shape[2])


jax.tree_util.register_pytree_node(
    PartitionedCSR2D,
    lambda g: ((g.row_local, g.col_local, g.col_global),
               (g.n_nodes, g.n_loc, g.n_edges, g.n_shards)),
    lambda meta, data: PartitionedCSR2D(*data, *meta),
)


def partition_csr_2d(csr: CSRGraph, n_shards: int, *, pad_to: int = 128) -> PartitionedCSR2D:
    """Host-side 2-D edge bucketing with uniform contiguous node blocks."""
    n = csr.n_nodes
    n_loc = -(-n // n_shards)
    row_ptr = np.asarray(jax.device_get(csr.row_ptr)).astype(np.int64)
    cols = np.asarray(jax.device_get(csr.col_idx))[: csr.n_edges]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))

    ds = (rows // n_loc).astype(np.int64)
    ss = (cols // n_loc).astype(np.int64)
    counts = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(counts, (ds, ss), 1)
    e2 = int(counts.max()) if csr.n_edges else pad_to
    e2 = max(((e2 + pad_to - 1) // pad_to) * pad_to, pad_to)

    row_local = np.full((n_shards, n_shards, e2), n_loc, np.int32)
    col_local = np.full((n_shards, n_shards, e2), n_loc, np.int32)
    col_global = np.full((n_shards, n_shards, e2), n, np.int32)
    fill = np.zeros((n_shards, n_shards), np.int64)
    for e in range(rows.shape[0]):
        a, b = ds[e], ss[e]
        k = fill[a, b]
        row_local[a, b, k] = rows[e] - a * n_loc
        col_local[a, b, k] = cols[e] - b * n_loc
        col_global[a, b, k] = cols[e]
        fill[a, b] += 1

    return PartitionedCSR2D(
        row_local=jnp.asarray(row_local),
        col_local=jnp.asarray(col_local),
        col_global=jnp.asarray(col_global),
        n_nodes=n, n_loc=n_loc, n_edges=csr.n_edges, n_shards=n_shards,
    )


def _local_ring(row_local, col_local, col_global, fts_blk, ld_blk, ls_full,
                seed, *, n_nodes: int, n_loc: int, n_shards: int,
                slope: float, coef_dropout: float):
    """Per-shard body. Shapes (leading sharded dims already squeezed):
    row_local/col_local/col_global (S, E2); fts_blk (n_loc, K, D);
    ld_blk (n_loc, K); ls_full (N, K) replicated; seed (1,) int32."""
    s = jax.lax.axis_index(GRAPH_AXIS)
    k = fts_blk.shape[1]
    d = fts_blk.shape[2]

    # --- softmax statistics over ALL local buckets (features not needed) --
    ld_pad = jnp.concatenate([ld_blk, jnp.zeros((1, k), ld_blk.dtype)], axis=0)
    ls_pad = jnp.concatenate([ls_full, jnp.zeros((1, k), ls_full.dtype)], axis=0)

    def bucket_logits(b):
        le = leaky_relu(ld_pad[row_local[b]] + ls_pad[col_global[b]], slope)
        valid = col_global[b] < jnp.int32(n_nodes)
        return jnp.where(valid[:, None], le, MASK_VALUE), valid

    n_seg = n_loc + 1
    m = jnp.full((n_seg, k), MASK_VALUE)
    for b in range(n_shards):  # static: max pass
        le, _ = bucket_logits(b)
        m = jnp.maximum(m, jax.ops.segment_max(
            le, row_local[b], num_segments=n_seg))
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    m = jnp.maximum(m, MASK_VALUE * 0.5)  # rows w/o edges: stable exp
    denom = jnp.zeros((n_seg, k))
    for b in range(n_shards):  # static: sum pass
        le, valid = bucket_logits(b)
        e = jnp.where(valid[:, None], jnp.exp(le - m[row_local[b]]), 0.0)
        denom = denom + jax.ops.segment_sum(e, row_local[b], num_segments=n_seg)

    # --- ring aggregation: features rotate, buckets consumed in step order -
    acc = jnp.zeros((n_loc, k, d))
    # the carry must match the loop output's device-varying type
    acc = jax.lax.pcast(acc, (GRAPH_AXIS, HEAD_AXIS), to="varying")

    def ring_step(t, carry):
        acc, blk = carry
        src_shard = (s - t) % n_shards
        rl = jax.lax.dynamic_index_in_dim(row_local, src_shard, 0, keepdims=False)
        cl = jax.lax.dynamic_index_in_dim(col_local, src_shard, 0, keepdims=False)
        cg = jax.lax.dynamic_index_in_dim(col_global, src_shard, 0, keepdims=False)
        valid = cg < jnp.int32(n_nodes)
        le = leaky_relu(ld_pad[rl] + ls_pad[cg], slope)
        e = jnp.where(valid[:, None], jnp.exp(le - m[rl]), 0.0)
        coefs = e / jnp.maximum(denom[rl], 1e-30)  # (E2, K)
        if coef_dropout > 0.0:
            # reference order: softmax first, dropout on the coefficients
            # (layers.py:27-30); per-(dst shard, src shard, head axis) stream
            hi = jax.lax.axis_index(HEAD_AXIS)
            key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(seed[0]), s), src_shard), hi)
            keep = 1.0 - coef_dropout
            mask = jax.random.bernoulli(key, keep, coefs.shape)
            coefs = jnp.where(mask, coefs / keep, 0.0)
        blk_pad = jnp.concatenate([blk, jnp.zeros((1, k, d), blk.dtype)], axis=0)
        vals = coefs[:, :, None] * blk_pad[jnp.minimum(cl, n_loc)]
        acc = acc + jax.ops.segment_sum(vals, rl, num_segments=n_seg)[:n_loc]
        # rotate feature blocks one step around the ring
        blk = jax.lax.ppermute(
            blk, GRAPH_AXIS,
            perm=[(i, (i + 1) % n_shards) for i in range(n_shards)])
        return acc, blk

    acc, _ = jax.lax.fori_loop(0, n_shards, ring_step, (acc, fts_blk))
    return acc.astype(fts_blk.dtype)


def ring_attention(
    graph: PartitionedCSR2D,
    fts: jax.Array,       # (N, K, D) — will live sharded over the graph axis
    logit_dst: jax.Array,  # (N, K)
    logit_src: jax.Array,  # (N, K)
    *,
    mesh=None,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    dropout_rng: jax.Array | None = None,
):
    if mesh is None:
        mesh = jax.sharding.get_abstract_mesh()
        if mesh is None or mesh.empty:
            raise ValueError("ring_attention needs a mesh (pass mesh=...)")
    if coef_dropout > 0.0 and dropout_rng is None:
        raise ValueError("coef_dropout > 0 requires dropout_rng")
    n, k, d = fts.shape
    s = graph.n_shards
    n_pad = s * graph.n_loc

    fts_p = jnp.pad(fts, ((0, n_pad - n), (0, 0), (0, 0)))
    ld_p = jnp.pad(logit_dst, ((0, n_pad - n), (0, 0)))
    if coef_dropout > 0.0:
        seed = jax.random.randint(
            dropout_rng, (1,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    else:
        seed = jnp.zeros((1,), jnp.int32)

    local = partial(_local_ring, n_nodes=graph.n_nodes, n_loc=graph.n_loc,
                    n_shards=s, slope=slope, coef_dropout=coef_dropout)

    out_padded = shard_map(
        lambda rl, cl, cg, f, ldb, lsf, sd: local(rl[0], cl[0], cg[0], f,
                                                  ldb, lsf, sd),
        mesh=mesh,
        in_specs=(
            P(GRAPH_AXIS, None, None),       # row_local  (S, S, E2)
            P(GRAPH_AXIS, None, None),       # col_local
            P(GRAPH_AXIS, None, None),       # col_global
            P(GRAPH_AXIS, HEAD_AXIS, None),  # fts blocks (N_pad, K, D)
            P(GRAPH_AXIS, HEAD_AXIS),        # logit_dst  (N_pad, K)
            P(None, HEAD_AXIS),              # logit_src  (N, K) replicated
            P(None),                         # dropout seed
        ),
        out_specs=P(GRAPH_AXIS, HEAD_AXIS, None),
    )(graph.row_local, graph.col_local, graph.col_global, fts_p, ld_p,
      logit_src, seed)

    return out_padded[:n]
