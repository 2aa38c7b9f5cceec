"""Ring halo-exchange attention == single-device CSR attention (values and
gradients), with features sharded instead of replicated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.build import metapath_to_csr
from han_jax.graph.synthetic import planted_hetero
from han_jax.ops.attention import csr_attention
from han_jax.parallel.mesh import make_mesh
from han_jax.parallel.ring_attn import partition_csr_2d, ring_attention

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def case():
    ds = planted_hetero(n_nodes=72, n_feats=12, n_classes=3, n_metapaths=1,
                        avg_degree=6.0, train_per_class=8, n_val=8, seed=13)
    csr = metapath_to_csr(ds.metapath_adjs[0], edge_pad_to=32)
    rng = np.random.default_rng(2)
    n, k, d = csr.n_nodes, 4, 6
    fts = jnp.asarray(rng.standard_normal((n, k, d)).astype(np.float32))
    ld = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    return csr, fts, ld, ls


def test_bucketing_covers_all_edges(case):
    csr, *_ = case
    pg = partition_csr_2d(csr, 4, pad_to=16)
    real = int((np.asarray(pg.col_global) < csr.n_nodes).sum())
    assert real == csr.n_edges


@pytest.mark.parametrize("mesh_shape", [(4, 1), (4, 2), (8, 1)])
def test_ring_matches_single_device(case, mesh_shape):
    csr, fts, ld, ls = case
    g, h = mesh_shape
    mesh = make_mesh(graph=g, heads=h)
    pg = partition_csr_2d(csr, g, pad_to=16)
    ref = csr_attention(csr, fts, ld, ls)
    with jax.set_mesh(mesh):
        out = jax.jit(lambda f, a, b: ring_attention(pg, f, a, b))(fts, ld, ls)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-5, rtol=3e-5)


def test_ring_gradients(case):
    csr, fts, ld, ls = case
    mesh = make_mesh(graph=4, heads=2)
    pg = partition_csr_2d(csr, 4, pad_to=16)

    def loss_ref(f, a, b):
        return jnp.sum(csr_attention(csr, f, a, b) ** 2)

    def loss_ring(f, a, b):
        return jnp.sum(ring_attention(pg, f, a, b) ** 2)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(fts, ld, ls)
    with jax.set_mesh(mesh):
        g_ring = jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(fts, ld, ls)
    for a, b in zip(g_ref, g_ring):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=1e-4, rtol=1e-4)


def test_ring_dropout_and_dispatch(case):
    """coef_dropout on the ring backend: deterministic in the rng, differs
    across keys, inverted-dropout mean ≈ no-drop output; and the container
    type dispatches through attention_aggregate (GATConv reachable)."""
    from han_jax.ops.attention import attention_aggregate

    csr, fts, ld, ls = case
    mesh = make_mesh(graph=4, heads=1)
    pg = partition_csr_2d(csr, 4, pad_to=16)
    with jax.set_mesh(mesh):
        f = jax.jit(lambda key: attention_aggregate(
            pg, fts, ld, ls, coef_dropout=0.4, dropout_rng=key))
        o1, o2 = f(jax.random.PRNGKey(0)), f(jax.random.PRNGKey(0))
        o3 = f(jax.random.PRNGKey(1))
        ref = jax.jit(lambda: attention_aggregate(pg, fts, ld, ls))()
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    assert not np.allclose(np.asarray(o1), np.asarray(o3))
    outs = []
    with jax.set_mesh(mesh):
        for s in range(200):
            outs.append(np.asarray(f(jax.random.PRNGKey(s))))
    # 200 Monte-Carlo samples → loose tolerance on the inverted-dropout mean
    np.testing.assert_allclose(np.stack(outs).mean(axis=0), np.asarray(ref),
                               atol=0.25)


def test_han_trains_on_ring_backend(case, tmp_path):
    """HAN end-to-end on graph_format='ring' with dropout — the ring
    backend is a real training path, not a demo."""
    from han_jax.graph.synthetic import planted_hetero
    from han_jax.train.config import preset
    from han_jax.train.trainer import MetricLogger, Trainer

    ds = planted_hetero(n_nodes=96, n_feats=16, n_classes=3, n_metapaths=2,
                        avg_degree=6.0, train_per_class=10, n_val=12, seed=4)
    cfg = preset("acm")
    cfg.data.graph_format = "ring"
    cfg.model.hid_units = (8,)
    cfg.model.n_heads = (2, 1)
    cfg.model.attn_drop = 0.3
    cfg.model.ffd_drop = 0.3
    cfg.train.epochs = 3
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    cfg.mesh.graph_axis = 4

    class Cap(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)
            self.rows = []

        def log(self, rec):
            self.rows.append(rec)

    cap = Cap()
    Trainer(ds, cfg, logger=cap).fit()
    losses = [r["train_loss"] for r in cap.rows if "train_loss" in r]
    assert len(losses) == 3 and all(np.isfinite(v) for v in losses)
