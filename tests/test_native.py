"""Native graphcore library vs scipy references (builds the .so on first
run; all entry points also exercise the pure-python fallback)."""

import numpy as np
import pytest
import scipy.sparse as sp

from han_jax import native


@pytest.fixture(scope="module")
def rnd():
    return np.random.default_rng(0)


def test_build_succeeds():
    assert native.available(), "g++ build of libgraphcore.so failed"


def test_csr_from_coo(rnd):
    n, nnz = 50, 400
    rows = rnd.integers(0, n, nnz).astype(np.int32)
    cols = rnd.integers(0, n, nnz).astype(np.int32)
    rp, ci = native.csr_from_coo(n, rows, cols)
    ref = sp.coo_matrix((np.ones(nnz), (rows, cols)), shape=(n, n)).tocsr()
    ref.sum_duplicates()
    np.testing.assert_array_equal(rp, ref.indptr.astype(np.int64))
    np.testing.assert_array_equal(ci, ref.indices.astype(np.int32))


def test_spgemm_binary(rnd):
    a = sp.random(40, 30, density=0.1, random_state=1, format="csr")
    b = sp.random(30, 45, density=0.1, random_state=2, format="csr")
    rp, ci = native.spgemm_binary(
        a.indptr.astype(np.int64), a.indices.astype(np.int32),
        b.indptr.astype(np.int64), b.indices.astype(np.int32), 40, 45)
    ref = (a @ b).tocsr()
    ref.data[:] = 1.0
    ref.eliminate_zeros()
    ref.sort_indices()
    np.testing.assert_array_equal(rp, ref.indptr.astype(np.int64))
    np.testing.assert_array_equal(ci, ref.indices.astype(np.int32))


def test_sample_neighbors(rnd):
    a = sp.random(60, 60, density=0.2, random_state=3, format="csr")
    rp = a.indptr.astype(np.int64)
    ci = a.indices.astype(np.int32)
    fanout = 4
    out = native.sample_neighbors(rp, ci, fanout, seed=7)
    assert out.shape == (60, fanout)
    deg = np.diff(rp)
    for i in range(60):
        row = out[i]
        real = row[row < 60]
        assert len(real) == min(deg[i], fanout)
        assert len(np.unique(real)) == len(real)  # without replacement
        assert set(real) <= set(ci[rp[i]:rp[i + 1]])
    # deterministic
    out2 = native.sample_neighbors(rp, ci, fanout, seed=7)
    np.testing.assert_array_equal(out, out2)


def test_connected_components():
    a = np.zeros((7, 7), np.float32)
    for i, j in [(0, 1), (1, 2), (3, 4), (5, 6)]:
        a[i, j] = a[j, i] = 1
    m = sp.csr_matrix(a)
    k, comp = native.connected_components(
        m.indptr.astype(np.int64), m.indices.astype(np.int32))
    assert k == 3
    assert comp[0] == comp[1] == comp[2]
    assert comp[3] == comp[4] and comp[5] == comp[6]
    assert len({comp[0], comp[3], comp[5]}) == 3
