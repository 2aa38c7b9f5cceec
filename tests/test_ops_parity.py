"""Cross-implementation parity for the attention aggregation ops.

The dense path is the oracle (bit-for-bit the reference masked-softmax math,
utils/layers.py:26-34); the ELL and CSR paths must agree to fp32 tolerance —
including underflow-to-zero of -1e9-masked entries, empty rows, self-loop-only
rows (SURVEY.md §4.1-4.2 hard cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.containers import (
    csr_from_dense, dense_from_numpy, ell_from_csr,
)
from han_jax.ops.attention import (
    csr_attention, dense_attention, ell_attention,
    sddmm_edge_logits, segment_softmax, spmm_aggregate,
)


def random_graph_case(n, k, d, seed, *, empty_rows=False, self_loops_only=False):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.15).astype(np.float32)
    if self_loops_only:
        a[:] = 0
    np.fill_diagonal(a, 1.0)
    if empty_rows:
        a[1] = 0.0  # node 1 attends to nothing at all (no self-loop)
        a[3] = 0.0
    dense = dense_from_numpy(a, add_self_loops=False)
    csr = csr_from_dense(dense, edge_pad_to=64)
    ell = ell_from_csr(csr)
    fts = jnp.asarray(rng.standard_normal((n, k, d)).astype(np.float32))
    ld = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    return dense, csr, ell, fts, ld, ls, a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_matches_manual_reference(seed):
    """Dense impl == literal transcription of utils/layers.py:26-34."""
    n, k, d = 33, 4, 8
    dense, _, _, fts, ld, ls, a = random_graph_case(n, k, d, seed)
    out = dense_attention(dense, fts, ld, ls, slope=0.2)

    bias = np.where(a > 0, 0.0, -1e9).astype(np.float32)
    fts_n, ld_n, ls_n = map(np.asarray, (fts, ld, ls))
    expected = np.zeros((n, k, d), np.float32)
    for h in range(k):
        logits = ld_n[:, h][:, None] + ls_n[:, h][None, :]
        lre = np.where(logits >= 0, logits, 0.2 * logits)
        z = lre + bias
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        coefs = e / e.sum(axis=1, keepdims=True)
        expected[:, h, :] = coefs @ fts_n[:, h, :]
    np.testing.assert_allclose(np.asarray(out), expected, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["normal", "self_loops_only"])
def test_csr_and_ell_match_dense(seed, case):
    n, k, d = 48, 3, 5
    dense, csr, ell, fts, ld, ls, _ = random_graph_case(
        n, k, d, seed, self_loops_only=(case == "self_loops_only"))
    out_d = dense_attention(dense, fts, ld, ls)
    out_c = csr_attention(csr, fts, ld, ls)
    out_e = ell_attention(ell, fts, ld, ls)
    np.testing.assert_allclose(np.asarray(out_c), np.asarray(out_d), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(np.asarray(out_e), np.asarray(out_d), atol=3e-5, rtol=3e-5)


def test_empty_rows_sparse_yields_zero():
    """Rows with zero edges: sparse spec outputs exactly 0 (SURVEY §7: the
    dense -1e9 path would give uniform attention; sparse-zero is the spec)."""
    n, k, d = 16, 2, 4
    _, csr, ell, fts, ld, ls, a = random_graph_case(1, 1, 1, 0)
    rng = np.random.default_rng(0)
    a = (rng.random((n, n)) < 0.3).astype(np.float32)
    a[5] = 0.0
    dense = dense_from_numpy(a, add_self_loops=False)
    csr = csr_from_dense(dense, edge_pad_to=64)
    ell = ell_from_csr(csr)
    fts = jnp.asarray(rng.standard_normal((n, k, d)).astype(np.float32))
    ld = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    out_c = np.asarray(csr_attention(csr, fts, ld, ls))
    out_e = np.asarray(ell_attention(ell, fts, ld, ls))
    np.testing.assert_array_equal(out_c[5], np.zeros((k, d), np.float32))
    np.testing.assert_array_equal(out_e[5], np.zeros((k, d), np.float32))
    # non-empty rows still match dense
    mask = np.ones(n, bool); mask[5] = False
    out_d = np.asarray(dense_attention(dense, fts, ld, ls))
    np.testing.assert_allclose(out_c[mask], out_d[mask], atol=3e-5, rtol=3e-5)


def test_segment_softmax_rows_sum_to_one():
    n, k, d = 40, 2, 3
    _, csr, _, fts, ld, ls, _ = random_graph_case(n, k, d, 3)
    le = sddmm_edge_logits(csr, ld, ls)
    coefs = segment_softmax(csr, le)
    rows = np.asarray(csr.row_idx)
    sums = np.zeros((n + 1, k), np.float32)
    np.add.at(sums, rows, np.asarray(coefs))
    deg = np.diff(np.asarray(csr.row_ptr))
    nonempty = deg > 0
    np.testing.assert_allclose(sums[:n][nonempty], 1.0, atol=1e-5)
    # padding contributed nothing
    assert np.all(np.asarray(coefs)[csr.n_edges:] == 0.0)


def test_spmm_gradients_flow():
    n, k, d = 24, 2, 4
    _, csr, _, fts, ld, ls, _ = random_graph_case(n, k, d, 5)

    def f(fts, ld, ls):
        return jnp.sum(csr_attention(csr, fts, ld, ls) ** 2)

    grads = jax.grad(f, argnums=(0, 1, 2))(fts, ld, ls)
    for g in grads:
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).sum()) > 0.0


def test_coef_dropout_scales_correctly():
    """E[dropout(coefs)] == coefs (inverted dropout, reference tf.nn.dropout)."""
    n, k, d = 32, 2, 4
    dense, _, _, fts, ld, ls, _ = random_graph_case(n, k, d, 9)
    out_ref = dense_attention(dense, fts, ld, ls)
    f = jax.jit(lambda key: dense_attention(
        dense, fts, ld, ls, coef_dropout=0.4, dropout_rng=key))
    outs = [np.asarray(f(jax.random.PRNGKey(s))) for s in range(500)]
    mean = np.stack(outs).mean(axis=0)
    np.testing.assert_allclose(mean, np.asarray(out_ref), atol=0.1)


def test_edge_attention_coefs_matches_segment_softmax():
    """The lane-efficient head-looped analysis path (edge_attention_coefs)
    equals the generic csr coefficients exactly."""
    import numpy as np
    import jax.numpy as jnp
    from han_jax.graph.build import metapath_to_csr
    from han_jax.graph.synthetic import planted_hetero
    from han_jax.ops.attention import (edge_attention_coefs,
                                       segment_softmax, sddmm_edge_logits)

    ds = planted_hetero(n_nodes=90, n_feats=8, n_classes=3, n_metapaths=1,
                        avg_degree=5.0, train_per_class=8, n_val=8, seed=2)
    g = metapath_to_csr(ds.metapath_adjs[0], edge_pad_to=64)
    rng = np.random.default_rng(0)
    ld = jnp.asarray(rng.standard_normal((90, 4)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((90, 4)).astype(np.float32))
    ref = segment_softmax(g, sddmm_edge_logits(g, ld, ls))
    got = edge_attention_coefs(g, ld, ls)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-7)
