"""Model-level tests (SURVEY.md §4.3): shapes, gradient flow, overfit sanity,
cross-backend equivalence of the full HAN forward."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from han_jax.graph.build import metapath_to_csr, metapath_to_dense
from han_jax.graph.containers import ell_from_csr
from han_jax.nn.losses import l2_regularizer, masked_softmax_cross_entropy
from han_jax.nn.models import GAT, HAN, HANShared


def make_inputs(ds, kind="dense"):
    if kind == "dense":
        graphs = [metapath_to_dense(a) for a in ds.metapath_adjs]
    elif kind == "csr":
        graphs = [metapath_to_csr(a, edge_pad_to=64) for a in ds.metapath_adjs]
    else:
        graphs = [ell_from_csr(metapath_to_csr(a, edge_pad_to=64))
                  for a in ds.metapath_adjs]
    x = jnp.asarray(ds.features)
    xs = [x for _ in graphs]
    return graphs, xs


def test_han_shapes_and_alphas(tiny_ds):
    graphs, xs = make_inputs(tiny_ds)
    model = HAN(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(4, 1))
    params = model.init(jax.random.PRNGKey(0), graphs, xs)
    logits, embed, alphas = model.apply(params, graphs, xs)
    n = tiny_ds.n_nodes
    assert logits.shape == (n, tiny_ds.n_classes)
    assert embed.shape == (n, 4 * 8)
    assert alphas.shape == (n, len(graphs))
    np.testing.assert_allclose(np.asarray(alphas.sum(-1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("kind", ["csr", "ell"])
def test_han_backends_agree(tiny_ds, kind):
    graphs_d, xs = make_inputs(tiny_ds, "dense")
    graphs_s, _ = make_inputs(tiny_ds, kind)
    model = HAN(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1))
    params = model.init(jax.random.PRNGKey(1), graphs_d, xs)
    out_d = model.apply(params, graphs_d, xs)
    out_s = model.apply(params, graphs_s, xs)
    # fp32 summation-order drift compounds through 2 layers + softmaxes;
    # single-op parity is pinned tighter in test_ops_parity.py
    for a, b in zip(out_d, out_s):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("kind", ["dense", "csr", "ell"])
def test_han_bf16_close_to_f32(tiny_ds, kind):
    """bf16 compute dtype: features/matmul transforms in
    bf16, params + logits + accumulators f32 — outputs track the f32 model
    to bf16 tolerance on every backend; logits dtype stays f32."""
    graphs, xs = make_inputs(tiny_ds, kind)
    kw = dict(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1))
    m32 = HAN(**kw)
    m16 = HAN(dtype=jnp.bfloat16, **kw)
    params = m32.init(jax.random.PRNGKey(2), graphs, xs)
    out32 = m32.apply(params, graphs, xs)
    out16 = m16.apply(params, graphs, xs)
    assert out16[0].dtype == jnp.float32
    for a, b in zip(out16, out32):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-2, rtol=5e-2)


def test_han_bf16_trains(tiny_ds):
    """A few bf16 training steps stay finite and reduce the loss."""
    graphs, xs = make_inputs(tiny_ds, "csr")
    model = HAN(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1),
                dtype=jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(0), graphs, xs)
    labels = jnp.asarray(tiny_ds.labels)
    mask = jnp.asarray(tiny_ds.train_mask)
    tx = optax.adam(5e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt):
        def loss_fn(p):
            logits, _, _ = model.apply(p, graphs, xs)
            return masked_softmax_cross_entropy(logits, labels, mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt)
        return optax.apply_updates(params, upd), opt, loss

    losses = []
    for _ in range(12):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_han_all_params_receive_grads(tiny_ds):
    graphs, xs = make_inputs(tiny_ds)
    model = HAN(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1))
    params = model.init(jax.random.PRNGKey(0), graphs, xs)
    labels = jnp.asarray(tiny_ds.labels)
    mask = jnp.asarray(tiny_ds.train_mask)

    def loss_fn(p):
        logits, _, _ = model.apply(p, graphs, xs)
        return masked_softmax_cross_entropy(logits, labels, mask)

    grads = jax.grad(loss_fn)(params)
    flat = jax.tree_util.tree_leaves_with_path(grads)
    for path, g in flat:
        assert float(jnp.abs(g).sum()) > 0.0, f"zero grad at {path}"


def test_han_overfits_tiny(tiny_ds):
    """Overfit the training nodes — end-to-end learnability sanity."""
    graphs, xs = make_inputs(tiny_ds)
    model = HAN(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(4, 1))
    params = model.init(jax.random.PRNGKey(0), graphs, xs)
    labels = jnp.asarray(tiny_ds.labels)
    mask = jnp.asarray(tiny_ds.train_mask)
    tx = optax.adam(5e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits, _, _ = model.apply(p, graphs, xs)
            return masked_softmax_cross_entropy(logits, labels, mask) + \
                l2_regularizer(p, 1e-4)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(120):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert losses[-1] < 0.35, f"did not overfit: {losses[::20]}"

    logits, _, _ = model.apply(params, graphs, xs)
    pred = np.asarray(jnp.argmax(logits, -1))
    true = np.asarray(jnp.argmax(labels, -1))
    train_acc = (pred[np.asarray(mask)] == true[np.asarray(mask)]).mean()
    assert train_acc > 0.95


def test_gat_shapes(tiny_ds):
    graphs, xs = make_inputs(tiny_ds)
    model = GAT(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(4, 1))
    params = model.init(jax.random.PRNGKey(0), graphs[0], xs[0])
    logits = model.apply(params, graphs[0], xs[0])
    assert logits.shape == (tiny_ds.n_nodes, tiny_ds.n_classes)


def test_han_shared_coefs(tiny_ds):
    graphs, xs = make_inputs(tiny_ds)
    model = HANShared(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1),
                      return_coefs=True)
    params = model.init(jax.random.PRNGKey(0), graphs, xs[0])
    logits, embed, alphas, coef_list = model.apply(params, graphs, xs[0])
    assert len(coef_list) == len(graphs)
    n = tiny_ds.n_nodes
    for c in coef_list:
        assert c.shape == (n, n)
        np.testing.assert_allclose(np.asarray(c.sum(-1)), 1.0, atol=1e-5)


def test_han_shared_coefs_csr_edge_domain(tiny_ds):
    """Edge-domain coef output: HANShared(return_coefs=True)
    on the csr backend returns per-edge mean-over-head coefs whose scatter
    into an (N, N) matrix matches the dense oracle's coef matrix — so
    attention analysis (reference gat.py:148-173) works beyond the dense
    backend's O(N^2) reach."""
    dense_graphs, xs = make_inputs(tiny_ds, "dense")
    csr_graphs, _ = make_inputs(tiny_ds, "csr")
    kw = dict(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1),
              return_coefs=True)
    dense_model = HANShared(impl="dense", **kw)
    csr_model = HANShared(impl="csr", **kw)
    params = dense_model.init(jax.random.PRNGKey(0), dense_graphs, xs[0])
    _, _, _, dense_coefs = dense_model.apply(params, dense_graphs, xs[0])
    logits_c, _, _, edge_coefs = csr_model.apply(params, csr_graphs, xs[0])
    assert jnp.all(jnp.isfinite(logits_c))
    n = tiny_ds.n_nodes
    for g, ec, dc in zip(csr_graphs, edge_coefs, dense_coefs):
        assert ec.shape == (g.col_idx.shape[0],)
        rows = np.asarray(g.row_idx)[: g.n_edges]
        cols = np.asarray(g.col_idx)[: g.n_edges]
        mat = np.zeros((n, n), np.float32)
        mat[rows, cols] = np.asarray(ec)[: g.n_edges]
        np.testing.assert_allclose(mat, np.asarray(dc), atol=1e-5)
        # padding edges contribute exactly zero
        np.testing.assert_array_equal(np.asarray(ec)[g.n_edges:], 0.0)


def test_dropout_deterministic_flag(tiny_ds):
    graphs, xs = make_inputs(tiny_ds)
    model = HAN(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1),
                attn_drop=0.5, ffd_drop=0.5)
    params = model.init(jax.random.PRNGKey(0), graphs, xs)
    out1 = model.apply(params, graphs, xs, deterministic=True)
    out2 = model.apply(params, graphs, xs, deterministic=True)
    np.testing.assert_array_equal(np.asarray(out1[0]), np.asarray(out2[0]))
    # training mode differs across rng
    t1 = model.apply(params, graphs, xs, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(1)})
    t2 = model.apply(params, graphs, xs, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(2)})
    assert not np.allclose(np.asarray(t1[0]), np.asarray(t2[0]))
