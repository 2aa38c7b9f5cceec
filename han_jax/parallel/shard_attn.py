"""Sharded attention aggregation over the ('graph', 'heads') mesh.

``partitioned_attention`` is the distributed sibling of
``han_jax.ops.attention.csr_attention``: same math, executed under
``shard_map`` with

- the **graph axis** partitioning destination rows / their incoming edges
  (each device runs SDDMM → segment-softmax → SpMM on its own edge block);
- the **heads axis** partitioning the K attention heads (fully independent
  per head — reference gat.py:42-46 — so no collective is needed inside);
- source features replicated along the graph axis (XLA inserts the
  all-gather at shard_map entry; its transpose — psum of feature grads back
  to owners — is generated automatically by AD).

Because the container type selects this path through the normal op
dispatch, the *same model code* runs on one device or many — the
graph container is the distribution strategy.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from han_jax.graph.containers import MASK_VALUE
from han_jax.ops.attention import leaky_relu
from han_jax.parallel.edge_partition import PartitionedCSR
from han_jax.parallel.mesh import GRAPH_AXIS, HEAD_AXIS


def _local_csr_attention(
    row_ptr,    # (1, n_loc+1) local row pointers
    col_idx,    # (1, e_loc) global sources, pad = n_nodes
    row_idx,    # (1, e_loc) local rows, pad = n_loc
    fts,        # (N, K_loc, D) replicated over graph axis
    logit_dst_blk,  # (n_loc, K_loc) this shard's rows (padded layout)
    logit_src,  # (N, K_loc) replicated
    *,
    n_nodes: int,
    slope: float,
    coef_dropout: float,
    seed,        # (1, 1) int32 or None
):
    col = col_idx[0]
    row = row_idx[0]
    n_loc = row_ptr.shape[1] - 1
    k = fts.shape[1]
    d = fts.shape[2]

    ls_pad = jnp.concatenate([logit_src, jnp.zeros((1, k), logit_src.dtype)], axis=0)
    ld_pad = jnp.concatenate([logit_dst_blk, jnp.zeros((1, k), logit_dst_blk.dtype)],
                             axis=0)
    edge_mask = col < jnp.int32(n_nodes)

    le = leaky_relu(ld_pad[row] + ls_pad[col], slope)  # (e_loc, K)
    le = jnp.where(edge_mask[:, None], le, MASK_VALUE)

    n_seg = n_loc + 1
    seg_max = jax.ops.segment_max(le, row, num_segments=n_seg, indices_are_sorted=True)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    e = jnp.exp(le - seg_max[row])
    e = jnp.where(edge_mask[:, None], e, 0.0)
    seg_sum = jax.ops.segment_sum(e, row, num_segments=n_seg, indices_are_sorted=True)
    coefs = e / jnp.maximum(seg_sum[row], 1e-30)

    if coef_dropout > 0.0:
        # per-shard PRNG stream: fold in mesh coordinates
        gi = jax.lax.axis_index(GRAPH_AXIS)
        hi = jax.lax.axis_index(HEAD_AXIS)
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed[0, 0]), gi), hi)
        keep = 1.0 - coef_dropout
        mask = jax.random.bernoulli(key, keep, coefs.shape)
        coefs = jnp.where(mask, coefs / keep, 0.0)

    fts_pad = jnp.concatenate([fts, jnp.zeros((1, k, d), fts.dtype)], axis=0)
    vals = coefs[:, :, None] * fts_pad[col]  # (e_loc, K, D)
    out = jax.ops.segment_sum(vals, row, num_segments=n_seg, indices_are_sorted=True)
    return out[:n_loc].astype(fts.dtype)  # (n_loc, K_loc, D)


def partitioned_attention(
    graph: PartitionedCSR,
    fts: jax.Array,       # (N, K, D)
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
            raise ValueError("partitioned_attention needs a mesh (pass mesh=...)")
    n, k, d = fts.shape
    n_pad = graph.n_nodes_pad

    # destination logits in padded shard layout
    ld_padded = jnp.zeros((n_pad, k), logit_dst.dtype).at[graph.perm].set(logit_dst)

    if coef_dropout > 0.0:
        seed = jax.random.randint(dropout_rng, (1, 1), 0, jnp.iinfo(jnp.int32).max)
    else:
        seed = jnp.zeros((1, 1), jnp.int32)

    local = partial(
        _local_csr_attention,
        n_nodes=graph.n_nodes,
        slope=slope,
        coef_dropout=coef_dropout,
    )

    out_padded = shard_map(
        lambda rp, ci, ri, f, ld, ls, sd: local(rp, ci, ri, f, ld, ls, seed=sd),
        mesh=mesh,
        in_specs=(
            P(GRAPH_AXIS, None),          # row_ptr   (S, n_loc+1)
            P(GRAPH_AXIS, None),          # col_idx   (S, e_loc)
            P(GRAPH_AXIS, None),          # row_idx   (S, e_loc)
            P(None, HEAD_AXIS, None),     # fts       (N, K, D) heads sharded
            P(GRAPH_AXIS, HEAD_AXIS),     # logit_dst (N_pad, K)
            P(None, HEAD_AXIS),           # logit_src (N, K)
            P(None, None),                # seed
        ),
        out_specs=P(GRAPH_AXIS, HEAD_AXIS, None),
    )(graph.row_ptr, graph.col_idx, graph.row_idx, fts, ld_padded, logit_src, seed)

    # padded shard layout → global row order
    return out_padded[graph.perm]
