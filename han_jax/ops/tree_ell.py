"""Scatter-free attention for TREE-structured ELL blocks (device-sampled
mini-batches).

The device-side sampler's no-dedup L-hop block (train/sampled.py
``_device_sample_block``) references every non-root row from EXACTLY ONE
``nbr[r, f]`` slot — the block is a forest rooted at the seeds. So the
d_logit_src / d_values transposes of the attention backward, which for a
general graph are scatter-adds, collapse to SINGLE GATHERS through the
precomputed parent maps:

    dls[j] = dz[parent_row[j], parent_slot[j]]          (one reference)
    dv[j]  = c~[parent_row[j], parent_slot[j]] * g[parent_row[j]]

Forward math is identical to ops.attention.ell_attention (flat-(K*D)
gather layout); coefficient dropout draws its keep mask ONCE in XLA so
the backward replays it exactly.
Dispatched by container type (graph/containers.TreeEllGraph) from
attention_aggregate, like the distributed containers.

Reference spec: utils/layers.py:26-34 masked attention, restricted to a
sampled block (the reference has no sampling at all — SURVEY.md §2.3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from han_jax.graph.containers import MASK_VALUE, TreeEllGraph


def _coefs(nbr, valid, fts_flat_pad, ld, ls, slope):
    """(coefs (N,F,K), raw logits) — shared fwd/bwd math."""
    k = ld.shape[1]
    ls_pad = jnp.concatenate([ls, jnp.zeros((1, k), ls.dtype)], axis=0)
    raw = ld[:, None, :] + ls_pad[nbr]                   # (N, F, K)
    z = jnp.where(raw >= 0, raw, slope * raw)
    z = jnp.where(valid[:, :, None], z, MASK_VALUE)
    m = jnp.max(z, axis=1, keepdims=True)
    e = jnp.where(valid[:, :, None], jnp.exp(z - m), 0.0)
    denom = jnp.maximum(jnp.sum(e, axis=1, keepdims=True), 1e-30)
    return e / denom, raw


@functools.partial(jax.custom_vjp, nondiff_argnums=(7, 8))
def _tree_core(nbr, parent_row, parent_slot, keep, fts, ld, ls,
               slope, dropout_p):
    out, _ = _tree_fwd(nbr, parent_row, parent_slot, keep, fts, ld, ls,
                       slope, dropout_p)
    return out


def _tree_fwd(nbr, parent_row, parent_slot, keep, fts, ld, ls,
              slope, dropout_p):
    n, k, d = fts.shape
    f = nbr.shape[1]
    valid = nbr < n
    fts_pad = jnp.concatenate(
        [fts.reshape(n, k * d), jnp.zeros((1, k * d), fts.dtype)], axis=0)
    coefs, _ = _coefs(nbr, valid, fts_pad, ld, ls, slope)
    if dropout_p > 0.0:
        c_agg = coefs * jnp.where(keep != 0, 1.0 / (1.0 - dropout_p), 0.0)
    else:
        c_agg = coefs
    gf = fts_pad[jnp.where(valid, nbr, n)]               # (N, F, K*D)
    # HIGHEST: full-f32 neighbor sums, as ops/attention.ell_attention
    out = jnp.einsum("nfk,nfkd->nkd", c_agg, gf.reshape(n, f, k, d),
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST).astype(fts.dtype)
    return out, (nbr, parent_row, parent_slot, keep, fts, ld, ls)


def _tree_bwd(slope, dropout_p, res, g):
    nbr, parent_row, parent_slot, keep, fts, ld, ls = res
    n, k, d = fts.shape
    f = nbr.shape[1]
    valid = nbr < n
    safe = jnp.where(valid, nbr, n)
    fts_pad = jnp.concatenate(
        [fts.reshape(n, k * d), jnp.zeros((1, k * d), fts.dtype)], axis=0)
    coefs, raw = _coefs(nbr, valid, fts_pad, ld, ls, slope)
    if dropout_p > 0.0:
        mk = jnp.where(keep != 0, 1.0 / (1.0 - dropout_p), 0.0)
        c_agg = coefs * mk
    else:
        mk = None
        c_agg = coefs

    g32 = g.astype(jnp.float32)
    gf = fts_pad[safe].reshape(n, f, k, d)
    gv = jnp.einsum("nkd,nfkd->nfk", g32, gf,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    gv_agg = gv * mk if mk is not None else gv
    dz = coefs * (gv_agg - jnp.sum(c_agg * gv, axis=1, keepdims=True))
    dz = jnp.where(raw >= 0, dz, slope * dz)
    dz = jnp.where(valid[:, :, None], dz, 0.0)

    dld = jnp.sum(dz, axis=1)                            # (N, K)

    # the tree transposes: gathers through the parent maps, no scatter
    has = parent_row < n
    pr = jnp.where(has, parent_row, 0)
    ps = parent_slot
    dls = jnp.where(has[:, None], dz[pr, ps], 0.0)       # (N, K)
    c_sel = jnp.where(has[:, None], c_agg[pr, ps], 0.0)  # (N, K)
    g_par = g32.reshape(n, k * d)[pr].reshape(n, k, d)
    dv = c_sel[:, :, None] * g_par                       # (N, K, D)
    dv = jnp.where(has[:, None, None], dv, 0.0)

    z0 = lambda a: np.zeros(a.shape, dtype=jax.dtypes.float0)
    return (z0(nbr), z0(parent_row), z0(parent_slot), z0(keep),
            dv.astype(fts.dtype), dld.astype(ld.dtype), dls.astype(ls.dtype))


_tree_core.defvjp(_tree_fwd, _tree_bwd)


def tree_ell_attention(
    graph: TreeEllGraph,
    fts: jax.Array,        # (N, K, D)
    logit_dst: jax.Array,  # (N, K)
    logit_src: jax.Array,  # (N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    dropout_rng: jax.Array | None = None,
):
    if coef_dropout > 0.0:
        if dropout_rng is None:
            raise ValueError("coef_dropout > 0 requires dropout_rng")
        n, k, _ = fts.shape
        keep = jax.random.bernoulli(
            dropout_rng, 1.0 - coef_dropout,
            (n, graph.nbr.shape[1], k)).astype(jnp.uint8)
    else:
        keep = jnp.zeros((1, 1, 1), jnp.uint8)
    return _tree_core(graph.nbr, graph.parent_row, graph.parent_slot, keep,
                      fts, logit_dst, logit_src, slope,
                      float(coef_dropout))


def tree_parent_maps(batch: int, fanout: int, hops: int,
                     block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Static parent maps of the no-dedup L-hop block layout
    (train/sampled._device_sample_block): level l+1 row ``base + r*F + f``
    is referenced by (level-l row r, slot f); roots/pads get sentinel
    block_size. Depends only on (batch, fanout, hops, block_size) — built
    once on the host."""
    pr = np.full(block_size, block_size, np.int32)
    ps = np.zeros(block_size, np.int32)
    level_base = 0
    level_size = batch
    for _ in range(hops):
        child_base = level_base + level_size
        idx = np.arange(level_size * fanout)
        pr[child_base: child_base + level_size * fanout] = \
            level_base + idx // fanout
        ps[child_base: child_base + level_size * fanout] = idx % fanout
        level_base = child_base
        level_size *= fanout
    return pr, ps
