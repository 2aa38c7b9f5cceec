"""Neighbor sampling: fanout bounds, determinism, subgraph locality, and
attention equivalence when fanout ≥ max degree."""

import numpy as np
import jax.numpy as jnp

from han_jax.graph.build import metapath_to_csr
from han_jax.graph.containers import ell_from_csr
from han_jax.graph.sampling import NeighborSampler, sample_subgraph
from han_jax.graph.synthetic import planted_hetero
from han_jax.ops.attention import ell_attention


def make_csr(n=80, deg=6.0, seed=3):
    ds = planted_hetero(n_nodes=n, n_feats=8, n_classes=2, n_metapaths=1,
                        avg_degree=deg, train_per_class=5, n_val=5, seed=seed)
    return metapath_to_csr(ds.metapath_adjs[0], edge_pad_to=32)


def test_sampler_fanout_and_determinism():
    csr = make_csr()
    s = NeighborSampler(csr, fanout=4, seed=9)
    e1 = s.sample(epoch=0)
    e2 = s.sample(epoch=0)
    e3 = s.sample(epoch=1)
    np.testing.assert_array_equal(np.asarray(e1.nbr), np.asarray(e2.nbr))
    assert not np.array_equal(np.asarray(e1.nbr), np.asarray(e3.nbr))
    assert e1.fanout == 4
    # sampled neighbors are a subset of true neighbors
    rp = np.asarray(csr.row_ptr)
    ci = np.asarray(csr.col_idx)
    nbr = np.asarray(e1.nbr)
    for i in range(csr.n_nodes):
        real = nbr[i][nbr[i] < csr.n_nodes]
        assert set(real) <= set(ci[rp[i]:rp[i + 1]])
        assert len(real) == min(rp[i + 1] - rp[i], 4)


def test_full_fanout_equals_exact_attention():
    """fanout ≥ max degree → sampled ELL == exact ELL attention."""
    csr = make_csr(n=60, deg=5.0)
    full = ell_from_csr(csr)
    s = NeighborSampler(csr, fanout=full.fanout, seed=0)
    sampled = s.sample(epoch=0)
    rng = np.random.default_rng(0)
    fts = jnp.asarray(rng.standard_normal((60, 2, 4)).astype(np.float32))
    ld = jnp.asarray(rng.standard_normal((60, 2)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((60, 2)).astype(np.float32))
    out_full = ell_attention(full, fts, ld, ls)
    out_sampled = ell_attention(sampled, fts, ld, ls)
    np.testing.assert_allclose(np.asarray(out_sampled), np.asarray(out_full),
                               atol=2e-5, rtol=2e-5)


def test_subgraph_block():
    csr = make_csr(n=100, deg=5.0)
    seeds = np.array([3, 7, 11], np.int32)
    blk = sample_subgraph(csr, seeds, fanout=3, hops=2, seed=1)
    assert blk.nodes[0] == 3 and blk.seed_mask[:3].all()
    n_block = blk.nodes.shape[0]
    # local neighbor indices point at real block rows
    real_rows = np.where(blk.nodes >= 0)[0]
    nbr = blk.nbr
    assert ((nbr == n_block) | np.isin(nbr, real_rows)).all()
    # ELL view is consistent
    ell = blk.ell()
    assert ell.n_nodes == n_block
    feats = np.arange(100 * 2, dtype=np.float32).reshape(100, 2)
    gf = blk.gather_features(feats)
    np.testing.assert_array_equal(gf[0], feats[3])
    assert (gf[blk.nodes < 0] == 0).all()


def test_native_block_sampler_matches_python_when_exhaustive():
    """With fanout >= max degree both the C++ sample_block and the Python
    fallback keep every neighbor → identical blocks (sorted neighbor order,
    BFS discovery order)."""
    from han_jax import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    csr = make_csr(n=60, deg=4.0, seed=7)
    import jax

    row_ptr = np.asarray(jax.device_get(csr.row_ptr)).astype(np.int64)
    max_deg = int(np.diff(row_ptr).max())
    seeds = np.array([3, 11, 42], np.int32)
    cap = int(seeds.shape[0] * (max_deg + 1) ** 2)

    sb = sample_subgraph(csr, seeds, fanout=max_deg, hops=2,
                         block_size=cap, seed=0)  # native path
    from han_jax.graph.sampling import SubgraphBatch  # python fallback, inline

    col_idx = np.asarray(jax.device_get(csr.col_idx))[: csr.n_edges]
    # force the python path by calling through a library-less shim
    import han_jax.graph.sampling as sampling_mod
    import unittest.mock as mock

    with mock.patch.object(sampling_mod.native, "sample_block",
                           lambda *a, **k: None):
        sb_py = sample_subgraph(csr, seeds, fanout=max_deg, hops=2,
                                block_size=cap, seed=0)
    np.testing.assert_array_equal(sb.nodes, sb_py.nodes)
    np.testing.assert_array_equal(sb.nbr, sb_py.nbr)
    assert sb.n_real == sb_py.n_real


def test_native_block_sampler_invariants_under_subsampling():
    """When fanout < degree the native sampler must still emit a valid
    block: local indices in range, seeds first, fanout bound respected."""
    from han_jax import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    csr = make_csr(n=200, deg=12.0, seed=1)
    seeds = np.arange(20, dtype=np.int32)
    cap = 20 * 5
    sb = sample_subgraph(csr, seeds, fanout=4, hops=1, block_size=cap, seed=9)
    assert (sb.nodes[:20] == seeds).all()
    assert 20 <= sb.n_real <= cap
    real_rows = sb.nbr[sb.nbr < cap]
    assert (real_rows >= 0).all() and (real_rows < sb.n_real).all()
    assert ((sb.nbr < cap).sum(axis=1) <= 4).all()
    # deterministic in seed
    sb2 = sample_subgraph(csr, seeds, fanout=4, hops=1, block_size=cap, seed=9)
    np.testing.assert_array_equal(sb.nbr, sb2.nbr)
