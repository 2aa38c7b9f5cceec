"""Dataset pipeline tests: real DBLP/IMDB raw builds, ACM fixture shapes,
PPI component batching invariants, graph container round trips."""

import numpy as np
import pytest
import scipy.sparse as sp

from han_jax.datasets.acm import acm_synthetic
from han_jax.datasets.base import REFERENCE_DATA
from han_jax.datasets.ppi import batch_components, ppi_synthetic
from han_jax.graph.build import symmetric_metapath, with_self_loops
from han_jax.graph.containers import csr_from_scipy, dense_from_csr, ell_from_csr


def test_acm_fixture_shapes():
    ds = acm_synthetic(seed=0)
    assert ds.n_nodes == 3025 and ds.features.shape == (3025, 1870)
    assert ds.n_classes == 3 and len(ds.metapath_adjs) == 2
    assert ds.train_mask.sum() == 600 and ds.val_mask.sum() == 300
    assert ds.test_mask.sum() == 2125
    # masks are disjoint and cover all nodes
    total = ds.train_mask.astype(int) + ds.val_mask + ds.test_mask
    assert (total == 1).all()
    # deterministic in seed
    ds2 = acm_synthetic(seed=0)
    assert (ds2.features == ds.features).all()


def test_metapath_composition():
    # papers 0,1 share author 0; paper 2 isolated author
    inc = sp.csr_matrix(np.array([[1, 0], [1, 0], [0, 1]], np.float32))
    apa = symmetric_metapath(inc)
    a = apa.toarray()
    assert a[0, 1] == 1 and a[1, 0] == 1
    assert a[0, 2] == 0 and a[2, 1] == 0
    with_loops = with_self_loops(apa).toarray()
    assert (np.diag(with_loops) == 1).all()


def test_csr_roundtrip_and_ell():
    rng = np.random.default_rng(0)
    a = sp.random(37, 37, density=0.1, random_state=0, format="csr")
    a.data[:] = 1.0
    csr = csr_from_scipy(a, edge_pad_to=16)
    assert csr.n_edges == a.nnz
    back = dense_from_csr(csr)
    np.testing.assert_array_equal(np.asarray(back.adj), a.toarray() > 0)
    ell = ell_from_csr(csr)
    assert ell.n_edges == a.nnz
    deg = np.asarray((a > 0).sum(axis=1)).ravel()
    np.testing.assert_array_equal(np.asarray(ell.deg), deg)
    np.testing.assert_array_equal(
        np.asarray(ell.nbr_mask).sum(axis=1), np.minimum(deg, ell.fanout))


def test_ppi_batching_isolation():
    ds = ppi_synthetic(seed=1)
    # every graph's padded region is fully masked out
    for g in range(ds.n_graphs):
        k = ds.node_mask[g].sum()
        assert not ds.adj[g, k:, :].any() and not ds.adj[g, :, k:].any()
        assert not ds.features[g, k:].any()
    # splits partition the graphs
    assert set(np.unique(ds.graph_split)) <= {0, 1, 2}
    assert (ds.graph_split == 0).sum() >= 1
    assert (ds.graph_split == 2).sum() >= 1


def test_batch_components_pure_splits():
    # two disjoint triangles with different splits must not be merged
    a = np.zeros((6, 6), np.float32)
    for i, j in [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)]:
        a[i, j] = a[j, i] = 1
    feats = np.eye(6, dtype=np.float32)
    labels = np.eye(6, dtype=np.float32)[:, :3]
    node_split = np.array([0, 0, 0, 2, 2, 2], np.int8)
    out = batch_components(sp.csr_matrix(a), feats, labels, node_split,
                           min_component=1, standardize=False)
    assert out.n_graphs == 2
    assert sorted(out.graph_split.tolist()) == [0, 2]


@pytest.mark.skipif(
    not (REFERENCE_DATA / "DBLP_four_area" / "author_label.txt").exists(),
    reason="raw DBLP data not present")
def test_dblp_real_build():
    from han_jax.datasets.dblp import load_dblp

    ds = load_dblp()
    assert ds.n_nodes == 4057 and ds.n_classes == 4
    assert ds.metapath_names == ("APA", "APCPA", "APTPA")
    # han.pdf Table 2 parity: +N self-loops → 11,113 / 5,000,495 edges
    assert ds.metapath_adjs[0].nnz + ds.n_nodes == 11113
    assert ds.metapath_adjs[1].nnz + ds.n_nodes == 5000495
    assert ds.train_mask.sum() == 800 and ds.val_mask.sum() == 400
    assert ds.test_mask.sum() == 2857


@pytest.mark.skipif(
    not (REFERENCE_DATA / "imdb" / "movie_metadata.csv").exists(),
    reason="raw IMDB data not present")
def test_imdb_real_build():
    from han_jax.datasets.imdb import load_imdb

    ds = load_imdb()
    assert ds.n_classes == 3
    assert ds.metapath_names == ("MAM", "MDM")
    assert 3000 < ds.n_nodes < 5100  # han.pdf Table 2 lists 4780
    assert ds.train_mask.sum() == 300 and ds.val_mask.sum() == 300


def test_normalize_adj_matches_reference_math():
    """D^-1/2 A D^-1/2 (utils/process.py:144-151) against a direct dense
    computation, including a zero-degree row."""
    from han_jax.graph.build import normalize_adj, preprocess_adj

    rng = np.random.default_rng(0)
    a = (rng.random((12, 12)) < 0.3).astype(np.float32)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0)
    a[5] = 0
    a[:, 5] = 0  # isolated node
    got = normalize_adj(sp.csr_matrix(a)).toarray()
    deg = a.sum(1)
    inv = np.where(deg > 0, deg ** -0.5, 0.0)
    ref = inv[:, None] * a * inv[None, :]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    # preprocess_adj = normalize_adj(A + I): isolated node becomes pure self
    pa = preprocess_adj(sp.csr_matrix(a)).toarray()
    assert np.isclose(pa[5, 5], 1.0)
