"""The csr and ell attention backends against the dense oracle: forward and
gradients on uniform, degree-skewed and empty-row graphs, bf16 features,
the coefficient-dropout keep rate, and the dispatch on container type."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.containers import (
    CSRGraph, DenseGraph, csr_from_dense, dense_from_numpy, ell_from_csr,
)
from han_jax.ops.attention import attention_aggregate

K, D = 4, 8


def _adjacency(kind: str, n: int, rng) -> np.ndarray:
    if kind == "uniform":
        a = rng.random((n, n)) < 0.12
    elif kind == "skewed":
        # Zipf-like source popularity plus a few hub rows that see most nodes
        pop = 1.0 / np.arange(1, n + 1) ** 1.1
        a = rng.random((n, n)) < np.minimum(1.0, 0.8 * pop[None, :] * n / 8)
        a[:3] = rng.random((3, n)) < 0.9
    elif kind == "empty_rows":
        a = rng.random((n, n)) < 0.12
        a[[1, 5, 9]] = False  # nodes that attend to nothing, not even self
        return a
    else:
        raise ValueError(kind)
    np.fill_diagonal(a, True)
    return a


def _case(kind: str, seed: int = 0, n: int = 64, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    a = _adjacency(kind, n, rng)
    dense = dense_from_numpy(a, add_self_loops=False)
    csr = csr_from_dense(dense, edge_pad_to=64)
    graphs = {"dense": dense, "csr": csr, "ell": ell_from_csr(csr)}
    fts = jnp.asarray(rng.standard_normal((n, K, D)), dtype)
    ld = jnp.asarray(rng.standard_normal((n, K)), jnp.float32)
    ls = jnp.asarray(rng.standard_normal((n, K)), jnp.float32)
    cot = jnp.asarray(rng.standard_normal((n, K, D)), jnp.float32)
    return graphs, fts, ld, ls, cot, a


def _value_and_grads(graph, impl, fts, ld, ls, cot):
    def loss(f, a, b):
        out = attention_aggregate(graph, f, a, b, impl=impl)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(fts, ld, ls)
    return (out,) + grads


@pytest.mark.parametrize("kind", ["uniform", "skewed", "empty_rows"])
@pytest.mark.parametrize("impl", ["csr", "ell"])
def test_backend_matches_dense_forward_and_grads(impl, kind):
    graphs, fts, ld, ls, cot, a = _case(kind)
    empty = ~a.any(axis=1)
    # the dense oracle spreads an edgeless row uniformly over all nodes
    # (every logit is masked alike); the sparse backends give it zero, so
    # those rows are left out of the loss and compared separately below
    cot = jnp.where(jnp.asarray(empty)[:, None, None], 0.0, cot)
    ref = _value_and_grads(graphs["dense"], "dense", fts, ld, ls, cot)
    got = _value_and_grads(graphs[impl], impl, fts, ld, ls, cot)
    keep = ~empty
    for name, x, y in zip(("out", "d_fts", "d_ld", "d_ls"), got, ref):
        x, y = np.asarray(x), np.asarray(y)
        if name == "out":
            x, y = x[keep], y[keep]
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)
    # rows with no in-edges aggregate nothing on the sparse backends
    np.testing.assert_array_equal(np.asarray(got[0])[empty], 0.0)
    assert empty.sum() == (3 if kind == "empty_rows" else 0)


@pytest.mark.parametrize("impl", ["csr", "ell"])
def test_backend_bf16_features_track_f32(impl):
    graphs, fts, ld, ls, cot, _ = _case("skewed", seed=3)
    ref = attention_aggregate(graphs["dense"], fts, ld, ls, impl="dense")
    out = attention_aggregate(graphs[impl], fts.astype(jnp.bfloat16), ld, ls,
                              impl=impl)
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("impl", ["csr", "ell", "dense"])
def test_coef_dropout_keep_rate(impl):
    """With all-ones features the output is sum_j mask_ij·coef_ij / keep,
    whose mean over rows and heads is 1 at the right keep rate; a
    different key gives a different mask."""
    rng = np.random.default_rng(5)
    n = 400
    a = rng.random((n, n)) < 0.1
    np.fill_diagonal(a, True)
    dense = dense_from_numpy(a, add_self_loops=False)
    csr = csr_from_dense(dense, edge_pad_to=64)
    graph = {"dense": dense, "csr": csr, "ell": ell_from_csr(csr)}[impl]
    fts = jnp.ones((n, K, 1), jnp.float32)
    ld = jnp.asarray(rng.standard_normal((n, K)), jnp.float32)
    ls = jnp.asarray(rng.standard_normal((n, K)), jnp.float32)

    def run(key):
        return np.asarray(attention_aggregate(
            graph, fts, ld, ls, impl=impl, coef_dropout=0.6,
            dropout_rng=jax.random.PRNGKey(key)))

    out = run(0)
    assert abs(out.mean() - 1.0) < 0.05
    assert np.abs(out - 1.0).max() > 0.1  # masks really drop edges
    assert not np.allclose(out, run(1))


@pytest.mark.parametrize("impl", ["auto", "dense", "csr", "ell"])
def test_auto_dispatch_follows_container(impl):
    graphs, fts, ld, ls, _, _ = _case("uniform", seed=1)
    ref = attention_aggregate(graphs["dense"], fts, ld, ls, impl="dense")
    container = "dense" if impl in ("auto", "dense") else impl
    out = attention_aggregate(graphs[container], fts, ld, ls, impl=impl)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_dispatch_errors():
    graphs, fts, ld, ls, _, _ = _case("uniform", seed=2)
    with pytest.raises(TypeError, match="unknown graph container"):
        attention_aggregate(object(), fts, ld, ls)
    with pytest.raises(ValueError, match="unknown impl"):
        attention_aggregate(graphs["csr"], fts, ld, ls, impl="flash")
    with pytest.raises(NotImplementedError, match="return_coefs"):
        attention_aggregate(graphs["ell"], fts, ld, ls, return_coefs=True)


def test_csr_return_coefs_match_dense():
    graphs, fts, ld, ls, _, _ = _case("skewed", seed=4)
    _, dense_coefs = attention_aggregate(graphs["dense"], fts, ld, ls,
                                         return_coefs=True)
    csr: CSRGraph = graphs["csr"]
    _, edge_coefs = attention_aggregate(csr, fts, ld, ls, return_coefs=True)
    rows = np.asarray(csr.row_idx)[: csr.n_edges]
    cols = np.asarray(csr.col_idx)[: csr.n_edges]
    dc = np.asarray(dense_coefs)  # (K, N, N)
    np.testing.assert_allclose(np.asarray(edge_coefs)[: csr.n_edges],
                               dc[:, rows, cols].T, rtol=1e-5, atol=1e-6)
    assert isinstance(graphs["dense"], DenseGraph)
