"""Graph attention aggregation ops — the framework's compute core.

One mathematical spec, several executions:

    logits[i, j, k] = leaky_relu(logit_dst[i, k] + logit_src[j, k])
    coefs[i, :, k]  = softmax over in-neighbors j of node i
    out[i, k, :]    = sum_j coefs[i, j, k] * fts[j, k, :]

This is the reference attention head factored into edge-domain form
(reference utils/layers.py:26-34 dense; utils/layers.py:93-115 sparse —
the two are numerically identical because exp(-1e9 + x) underflows to 0 in
fp32; see tests/test_ops_parity.py).

Implementations:

- ``dense``  — materialized (K, N, N) masked softmax; the oracle; O(N²) memory.
- ``ell``    — gather over fixed-fanout ELLPACK neighbor lists; O(N·F) memory.
- ``csr``    — COO/segment-domain: SDDMM → segment-softmax → SpMM via XLA
               segment ops; O(E) memory.

Other containers dispatch directly on type: TreeEllGraph → the
scatter-free tree backward (ops/tree_ell.py), PartitionedCSR → sharded
segment ops, PartitionedCSR2D → ring halo exchange (parallel/).

All take features in head-major layout ``fts: (N, K, D)`` and per-head node
logit terms ``logit_dst, logit_src: (N, K)`` and return ``(N, K, D)``.
"""

from __future__ import annotations

from typing import Literal

import jax
import jax.numpy as jnp

from han_jax.graph.containers import CSRGraph, DenseGraph, EllGraph, MASK_VALUE

Impl = Literal["auto", "dense", "ell", "csr"]


def leaky_relu(x: jax.Array, slope: float) -> jax.Array:
    return jnp.where(x >= 0, x, slope * x)


# ---------------------------------------------------------------------------
# dense — O(N^2) oracle (reference utils/layers.py:26-34 semantics)
# ---------------------------------------------------------------------------


def dense_attention(
    graph: DenseGraph,
    fts: jax.Array,  # (N, K, D) features used for aggregation (post-dropout)
    logit_dst: jax.Array,  # (N, K)
    logit_src: jax.Array,  # (N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    dropout_rng: jax.Array | None = None,
    return_coefs: bool = False,
):
    bias = graph.bias  # (N, N)
    # (K, N, N) logits: row i attends over columns j
    logits = logit_dst.T[:, :, None] + logit_src.T[:, None, :]
    coefs = jax.nn.softmax(leaky_relu(logits, slope) + bias[None, :, :], axis=-1)
    raw_coefs = coefs
    if coef_dropout > 0.0:
        keep = 1.0 - coef_dropout
        mask = jax.random.bernoulli(dropout_rng, keep, coefs.shape)
        coefs = jnp.where(mask, coefs / keep, 0.0)
    # HIGHEST, as in ell: every backend aggregates in full f32, also on
    # GPUs whose default dot precision is TF32
    out = jnp.einsum(
        "knm,mkd->nkd", coefs, fts, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(fts.dtype)
    if return_coefs:
        return out, raw_coefs
    return out


# ---------------------------------------------------------------------------
# ell — gather over fixed-fanout neighbor lists, O(N*F)
# ---------------------------------------------------------------------------


def ell_attention(
    graph: EllGraph,
    fts: jax.Array,  # (N, K, D)
    logit_dst: jax.Array,  # (N, K)
    logit_src: jax.Array,  # (N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    dropout_rng: jax.Array | None = None,
):
    n, k, d = fts.shape
    f = graph.nbr.shape[1]
    nbr = graph.nbr  # (N, F) with sentinel n
    valid = graph.nbr_mask  # (N, F)
    # pad a zero row at sentinel index n; the feature table is gathered in
    # flat (N, K*D) rows, one contiguous row per neighbor
    fts_pad = jnp.concatenate(
        [fts.reshape(n, k * d), jnp.zeros((1, k * d), fts.dtype)], axis=0)
    ls_pad = jnp.concatenate([logit_src, jnp.zeros((1, k), logit_src.dtype)], axis=0)

    g_ls = ls_pad[nbr]  # (N, F, K)
    logits = leaky_relu(logit_dst[:, None, :] + g_ls, slope)
    logits = jnp.where(valid[:, :, None], logits, MASK_VALUE)
    # stable softmax over F; fully-padded rows produce exactly 0 output
    m = jnp.max(logits, axis=1, keepdims=True)
    e = jnp.where(valid[:, :, None], jnp.exp(logits - m), 0.0)
    denom = jnp.sum(e, axis=1, keepdims=True)
    coefs = e / jnp.maximum(denom, 1e-30)  # (N, F, K)
    if coef_dropout > 0.0:
        keep = 1.0 - coef_dropout
        mask = jax.random.bernoulli(dropout_rng, keep, coefs.shape)
        coefs = jnp.where(mask, coefs / keep, 0.0)
    g_fts = fts_pad[nbr]  # (N, F, K*D)
    # HIGHEST: the weighted neighbor sum stays full f32 on GPUs whose
    # default dot precision is TF32, like the csr path's segment sums
    out = jnp.einsum(
        "nfk,nfkd->nkd", coefs, g_fts.reshape(n, f, k, d),
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    ).astype(fts.dtype)
    return out


# ---------------------------------------------------------------------------
# csr — edge/segment domain (SDDMM → segment softmax → SpMM), O(E)
# ---------------------------------------------------------------------------


def sddmm_edge_logits(
    graph: CSRGraph, logit_dst: jax.Array, logit_src: jax.Array, *, slope: float = 0.2
) -> jax.Array:
    """Edge logits l_e = leaky_relu(logit_dst[row_e] + logit_src[col_e]).

    Returns (E_pad, K); padding edges get MASK_VALUE.
    """
    k = logit_dst.shape[1]
    ld_pad = jnp.concatenate([logit_dst, jnp.zeros((1, k), logit_dst.dtype)], axis=0)
    ls_pad = jnp.concatenate([logit_src, jnp.zeros((1, k), logit_src.dtype)], axis=0)
    le = leaky_relu(ld_pad[graph.row_idx] + ls_pad[graph.col_idx], slope)
    return jnp.where(graph.edge_mask[:, None], le, MASK_VALUE)


def segment_softmax(graph: CSRGraph, edge_logits: jax.Array) -> jax.Array:
    """Numerically-stable softmax over each destination row's edges.

    edge_logits: (E_pad, K) → coefs (E_pad, K); padded edges → 0; rows with
    no edges produce no contribution anywhere.
    """
    n_seg = graph.n_nodes + 1  # sentinel row collects padding
    rows = graph.row_idx
    seg_max = jax.ops.segment_max(
        edge_logits, rows, num_segments=n_seg, indices_are_sorted=True
    )
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    e = jnp.exp(edge_logits - seg_max[rows])
    e = jnp.where(graph.edge_mask[:, None], e, 0.0)
    seg_sum = jax.ops.segment_sum(e, rows, num_segments=n_seg, indices_are_sorted=True)
    return e / jnp.maximum(seg_sum[rows], 1e-30)


def spmm_aggregate(graph: CSRGraph, coefs: jax.Array, fts: jax.Array) -> jax.Array:
    """out[i] = sum over edges e with row_e == i of coefs[e] * fts[col_e].

    coefs: (E_pad, K); fts: (N, K, D) → out (N, K, D), computed in the flat
    (E, K·D) layout: one gathered feature row per edge.
    """
    n, k, d = fts.shape
    fts_pad = jnp.concatenate(
        [fts.reshape(n, k * d), jnp.zeros((1, k * d), fts.dtype)], axis=0)
    cexp = jnp.repeat(coefs, d, axis=1)                # (E_pad, K·D)
    vals = cexp * fts_pad[graph.col_idx]               # (E_pad, K·D)
    out = jax.ops.segment_sum(
        vals, graph.row_idx, num_segments=n + 1, indices_are_sorted=True
    )
    return out[:n].reshape(n, k, d).astype(fts.dtype)


def edge_attention_coefs(graph: CSRGraph, logit_dst: jax.Array,
                         logit_src: jax.Array, *,
                         slope: float = 0.2) -> jax.Array:
    """Per-edge attention coefficients (E_pad, K) for analysis, computed
    head-at-a-time over 1-D edge arrays, so the live intermediates of one
    call are O(E) rather than O(E·K) (reference coef output,
    gat.py:148-173)."""
    k = logit_dst.shape[1]
    ld_pad = jnp.concatenate([logit_dst, jnp.zeros((1, k), logit_dst.dtype)])
    ls_pad = jnp.concatenate([logit_src, jnp.zeros((1, k), logit_src.dtype)])
    rows = graph.row_idx
    n_seg = graph.n_nodes + 1
    outs = []
    for h in range(k):
        le = leaky_relu(ld_pad[graph.row_idx, h] + ls_pad[graph.col_idx, h],
                        slope)
        le = jnp.where(graph.edge_mask, le, MASK_VALUE)
        seg_max = jax.ops.segment_max(le, rows, num_segments=n_seg,
                                      indices_are_sorted=True)
        seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
        e = jnp.where(graph.edge_mask, jnp.exp(le - seg_max[rows]), 0.0)
        seg_sum = jax.ops.segment_sum(e, rows, num_segments=n_seg,
                                      indices_are_sorted=True)
        outs.append(e / jnp.maximum(seg_sum[rows], 1e-30))
    return jnp.stack(outs, axis=1)


def csr_attention(
    graph: CSRGraph,
    fts: jax.Array,
    logit_dst: jax.Array,
    logit_src: jax.Array,
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    dropout_rng: jax.Array | None = None,
    return_coefs: bool = False,
):
    le = sddmm_edge_logits(graph, logit_dst, logit_src, slope=slope)
    coefs = segment_softmax(graph, le)
    # pre-dropout coefs, matching the dense oracle's return (the reference
    # returns the softmax output, gat.py:148-173); (E_pad, K) aligned with
    # graph.row_idx/col_idx, padding edges exactly 0
    raw_coefs = coefs
    if coef_dropout > 0.0:
        keep = 1.0 - coef_dropout
        mask = jax.random.bernoulli(dropout_rng, keep, coefs.shape)
        coefs = jnp.where(mask, coefs / keep, 0.0)
    out = spmm_aggregate(graph, coefs, fts)
    if return_coefs:
        return out, raw_coefs
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

# containers that carry their own execution: type name → (module, function).
# Looked up by name so this module imports none of them.
_BY_CONTAINER = {
    "TreeEllGraph": ("han_jax.ops.tree_ell", "tree_ell_attention"),
    "PartitionedCSR": ("han_jax.parallel.shard_attn", "partitioned_attention"),
    "PartitionedCSR2D": ("han_jax.parallel.ring_attn", "ring_attention"),
}


def attention_aggregate(
    graph,
    fts: jax.Array,
    logit_dst: jax.Array,
    logit_src: jax.Array,
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    dropout_rng: jax.Array | None = None,
    impl: Impl = "auto",
    return_coefs: bool = False,
):
    """Dispatch on graph container type / requested implementation."""
    dist = _BY_CONTAINER.get(type(graph).__name__)
    if dist is not None:
        if return_coefs:
            raise NotImplementedError(
                f"return_coefs unsupported on {type(graph).__name__}")
        import importlib

        fn = getattr(importlib.import_module(dist[0]), dist[1])
        return fn(graph, fts, logit_dst, logit_src, slope=slope,
                  coef_dropout=coef_dropout, dropout_rng=dropout_rng)
    if impl == "auto":
        if isinstance(graph, DenseGraph):
            impl = "dense"
        elif isinstance(graph, EllGraph):
            impl = "ell"
        elif isinstance(graph, CSRGraph):
            impl = "csr"
        else:
            raise TypeError(f"unknown graph container {type(graph)}")
    if impl == "dense":
        return dense_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, dropout_rng=dropout_rng,
            return_coefs=return_coefs,
        )
    if impl == "csr":
        return csr_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, dropout_rng=dropout_rng,
            return_coefs=return_coefs,
        )
    if impl == "ell":
        if return_coefs:
            # edge-domain coef output lives on the csr backend
            raise NotImplementedError(
                "return_coefs is supported by the dense and csr impls only")
        return ell_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, dropout_rng=dropout_rng,
        )
    raise ValueError(f"unknown impl {impl!r}")
