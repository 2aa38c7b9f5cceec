"""PartitionedCSR on S ∈ {2, 4, 8} graph shards: forward and gradients of
the sharded segment-op attention against the single-device csr backend,
on a degree-skewed graph whose edge-balanced shards own unequal row counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.containers import csr_from_dense, dense_from_numpy
from han_jax.ops.attention import attention_aggregate, csr_attention
from han_jax.parallel.edge_partition import partition_csr
from han_jax.parallel.mesh import make_mesh

N, K, D = 90, 4, 6


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(17)
    pop = 1.0 / np.arange(1, N + 1) ** 1.2
    a = rng.random((N, N)) < np.minimum(1.0, 0.6 * pop[:, None] * N / 6)
    np.fill_diagonal(a, True)
    csr = csr_from_dense(dense_from_numpy(a, add_self_loops=False),
                         edge_pad_to=32)
    fts = jnp.asarray(rng.standard_normal((N, K, D)), jnp.float32)
    ld = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    ls = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    cot = jnp.asarray(rng.standard_normal((N, K, D)), jnp.float32)
    return csr, fts, ld, ls, cot


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_partitioned_forward_matches_csr(case, shards):
    csr, fts, ld, ls, _ = case
    pg = partition_csr(csr, shards, edge_pad_to=32)
    assert pg.n_shards == shards and pg.n_edges == csr.n_edges
    ref = csr_attention(csr, fts, ld, ls)
    with jax.set_mesh(make_mesh(graph=shards)):
        out = jax.jit(lambda g, f, a, b: attention_aggregate(g, f, a, b))(
            pg, fts, ld, ls)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_partitioned_grads_match_csr(case, shards):
    csr, fts, ld, ls, cot = case
    pg = partition_csr(csr, shards, edge_pad_to=32)

    def loss(g, f, a, b):
        return jnp.sum(attention_aggregate(g, f, a, b) * cot)

    grad = jax.grad(loss, argnums=(1, 2, 3))
    ref = grad(csr, fts, ld, ls)
    with jax.set_mesh(make_mesh(graph=shards)):
        got = jax.jit(grad)(pg, fts, ld, ls)
    for name, x, y in zip(("d_fts", "d_ld", "d_ls"), got, ref):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=5e-5,
                                   atol=5e-5, err_msg=name)


def _dropout_samples(fn, n_keys):
    return np.stack([np.asarray(fn(jax.random.PRNGKey(s)))
                     for s in range(n_keys)])


@pytest.mark.parametrize("shards", [2, 4])
def test_partitioned_dropout_keep_rate_and_mean_match_csr(case, shards):
    """Attention dropout on the sharded path: the kept share of edge
    coefficients is the keep rate, as on csr, and the output averaged over
    keys is the dropout-free output (inverted dropout is unbiased)."""
    csr, fts, ld, ls, _ = case
    pg = partition_csr(csr, shards, edge_pad_to=32)
    rate, keep, n_keys = 0.6, 0.4, 48
    mesh = make_mesh(graph=shards)

    def sharded(g, f, a, b):
        return jax.jit(lambda key: attention_aggregate(
            g, f, a, b, coef_dropout=rate, dropout_rng=key))

    with jax.set_mesh(mesh):
        # uniform coefficients (zero logits) on unit features: each output
        # is (kept edges) / (degree · keep)
        zeros = jnp.zeros_like(ld)
        ones = jnp.ones_like(fts)
        deg = np.diff(np.asarray(csr.row_ptr))[:, None, None]
        kept = {
            "partitioned": _dropout_samples(
                sharded(pg, ones, zeros, zeros), n_keys) * deg * keep,
            "csr": _dropout_samples(jax.jit(lambda key: csr_attention(
                csr, ones, zeros, zeros, coef_dropout=rate,
                dropout_rng=key)), n_keys) * deg * keep,
        }
        mean = _dropout_samples(sharded(pg, fts, ld, ls), n_keys)
    n_draws = n_keys * csr.n_edges * K
    for name, k in kept.items():
        share = k[..., 0].sum() / n_draws
        assert abs(share - keep) < 4 * np.sqrt(keep * (1 - keep) / n_draws), \
            (name, share)
    ref = np.asarray(csr_attention(csr, fts, ld, ls))
    se = mean.std(axis=0) / np.sqrt(n_keys)
    assert np.all(np.abs(mean.mean(axis=0) - ref) <= 6 * se + 1e-6)


def test_partitioned_dropout_masks_differ_between_shards():
    """On a complete graph with uniform attention every row has the same
    edges in the same local order, so equal per-shard masks would repeat
    the output of a row in every shard: all rows must differ."""
    n, shards = 32, 4
    csr = csr_from_dense(dense_from_numpy(np.ones((n, n), bool),
                                          add_self_loops=False), edge_pad_to=32)
    pg = partition_csr(csr, shards, edge_pad_to=32)
    rng = np.random.default_rng(3)
    fts = jnp.asarray(rng.standard_normal((n, K, D)), jnp.float32)
    zeros = jnp.zeros((n, K), jnp.float32)
    with jax.set_mesh(make_mesh(graph=shards)):
        plain = np.asarray(attention_aggregate(pg, fts, zeros, zeros))
        dropped = np.asarray(jax.jit(lambda key: attention_aggregate(
            pg, fts, zeros, zeros, coef_dropout=0.5, dropout_rng=key))(
                jax.random.PRNGKey(0)))
    np.testing.assert_allclose(plain, plain[:1].repeat(n, 0), rtol=1e-5,
                               atol=1e-6)
    rows = np.round(dropped.reshape(n, -1), 5)
    assert len(np.unique(rows, axis=0)) == n
