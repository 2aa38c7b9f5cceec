"""Scatter-free tree-block attention (ops/tree_ell.py): the custom-VJP
gather backward must equal XLA autodiff through the same forward, with
and without coefficient dropout, on a real device-sampler block layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.containers import TreeEllGraph
from han_jax.ops.attention import attention_aggregate, ell_attention
from han_jax.ops import tree_ell


def make_tree_block(batch=6, fanout=3, hops=2, seed=0):
    """A random valid tree block in the device-sampler layout: some child
    slots invalid (sentinel), pad rows at the tail."""
    rng = np.random.default_rng(seed)
    total = sum(batch * fanout ** h for h in range(hops + 1))
    block = total + 5  # pad rows
    nbr = np.full((block, fanout), block, np.int32)
    base, size = 0, batch
    for _ in range(hops):
        child = base + size
        for r in range(size):
            for f in range(fanout):
                if rng.random() < 0.8:  # some slots invalid
                    nbr[base + r, f] = child + r * fanout + f
        base, size = child, size * fanout
    pr, ps = tree_ell.tree_parent_maps(batch, fanout, hops, block)
    deg = (nbr < block).sum(1).astype(np.int32)
    g = TreeEllGraph(nbr=jnp.asarray(nbr), deg=jnp.asarray(deg),
                     n_nodes=block, n_edges=block * fanout,
                     parent_row=jnp.asarray(pr), parent_slot=jnp.asarray(ps))
    k, d = 2, 4
    fts = jnp.asarray(rng.standard_normal((block, k, d)).astype(np.float32))
    ld = jnp.asarray(rng.standard_normal((block, k)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((block, k)).astype(np.float32))
    return g, fts, ld, ls


@pytest.mark.parametrize("dropout_p", [0.0, 0.4])
def test_tree_grads_match_autodiff(dropout_p):
    g, fts, ld, ls = make_tree_block()
    n, k, _ = fts.shape
    if dropout_p > 0.0:
        keep = jax.random.bernoulli(
            jax.random.PRNGKey(7), 1.0 - dropout_p,
            (n, g.nbr.shape[1], k)).astype(jnp.uint8)
    else:
        keep = jnp.zeros((1, 1, 1), jnp.uint8)

    def loss_custom(f, a, b):
        return tree_ell._tree_core(g.nbr, g.parent_row, g.parent_slot, keep,
                                   f, a, b, 0.2, dropout_p).sum()

    def loss_autodiff(f, a, b):
        # same forward WITHOUT the custom VJP → XLA scatter backward
        return tree_ell._tree_fwd(g.nbr, g.parent_row, g.parent_slot, keep,
                                  f, a, b, 0.2, dropout_p)[0].sum()

    out_c = tree_ell._tree_core(g.nbr, g.parent_row, g.parent_slot, keep,
                                fts, ld, ls, 0.2, dropout_p)
    out_r = tree_ell._tree_fwd(g.nbr, g.parent_row, g.parent_slot, keep,
                               fts, ld, ls, 0.2, dropout_p)[0]
    np.testing.assert_allclose(np.asarray(out_c), np.asarray(out_r),
                               rtol=1e-6, atol=1e-7)
    gc = jax.grad(loss_custom, argnums=(0, 1, 2))(fts, ld, ls)
    gr = jax.grad(loss_autodiff, argnums=(0, 1, 2))(fts, ld, ls)
    for a, b in zip(gc, gr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-6)


def test_tree_forward_matches_ell():
    """Tree dispatch (attention_aggregate on a TreeEllGraph) computes the
    same masked softmax aggregate as the generic ell backend on the same
    neighbor lists."""
    from han_jax.graph.containers import EllGraph

    g, fts, ld, ls = make_tree_block(seed=3)
    out_tree = attention_aggregate(g, fts, ld, ls)
    ell = EllGraph(nbr=g.nbr, deg=g.deg, n_nodes=g.n_nodes,
                   n_edges=g.n_edges)
    out_ell = ell_attention(ell, fts, ld, ls)
    np.testing.assert_allclose(np.asarray(out_tree), np.asarray(out_ell),
                               rtol=1e-5, atol=1e-6)
