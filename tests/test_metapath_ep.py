"""Meta-path (expert) parallelism — SURVEY §2.3 EP
row: vmapped tower stack over stacked graph containers, P axis pinned to a
'mp' mesh axis; parity vs the sequential HAN on the virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.build import metapath_to_csr, metapath_to_dense
from han_jax.graph.stack import stack_graphs
from han_jax.graph.synthetic import planted_hetero
from han_jax.nn.models import HAN
from han_jax.parallel.mesh import make_mesh
from han_jax.train.config import preset
from han_jax.train.trainer import MetricLogger, Trainer


@pytest.fixture(scope="module")
def ds():
    # P=4 meta-paths so the mp axis can take 2 or 4 shards
    return planted_hetero(n_nodes=150, n_feats=20, n_classes=3, n_metapaths=4,
                          avg_degree=7.0, train_per_class=12, n_val=20, seed=13)


def _stacked_to_sequential_params(params):
    """towers (P, ...) leaves → {tower_p: ...} trees matching the
    sequential HAN's parameter structure."""
    towers = params["params"]["towers"]
    p = jax.tree_util.tree_leaves(towers)[0].shape[0]
    out = {k: v for k, v in params["params"].items() if k != "towers"}
    for i in range(p):
        out[f"tower_{i}"] = jax.tree_util.tree_map(lambda a: a[i], towers)
    return {"params": out}


@pytest.mark.parametrize("builder", [metapath_to_csr, metapath_to_dense])
def test_vmap_towers_matches_sequential(ds, builder):
    graphs = [builder(a) for a in ds.metapath_adjs]
    stacked = stack_graphs(graphs)
    x = jnp.asarray(ds.features)
    xs = [x] * len(graphs)
    xs_stacked = jnp.stack(xs)

    m_seq = HAN(n_classes=3, hid_units=(8,), n_heads=(2, 1))
    m_ep = HAN(n_classes=3, hid_units=(8,), n_heads=(2, 1), vmap_towers=True)
    params_ep = m_ep.init(jax.random.PRNGKey(0), stacked, xs_stacked)
    params_seq = _stacked_to_sequential_params(params_ep)

    o_ep = m_ep.apply(params_ep, stacked, xs_stacked)
    o_seq = m_seq.apply(params_seq, graphs, xs)
    for a, b in zip(o_ep, o_seq):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, rtol=2e-5)


def test_ep_on_mp_mesh_axis(ds):
    """The vmapped tower stack executes under an (mp=4, graph=1, heads=2)
    mesh with the embeds constrained to P('mp') — numerics unchanged."""
    graphs = [metapath_to_csr(a) for a in ds.metapath_adjs]
    stacked = stack_graphs(graphs)
    x = jnp.asarray(ds.features)
    xs_stacked = jnp.stack([x] * len(graphs))
    m_ep = HAN(n_classes=3, hid_units=(8,), n_heads=(2, 1), vmap_towers=True)
    params = m_ep.init(jax.random.PRNGKey(0), stacked, xs_stacked)
    ref = m_ep.apply(params, stacked, xs_stacked)

    mesh = make_mesh(graph=1, heads=2, mp=4)
    with jax.set_mesh(mesh):
        out = jax.jit(lambda p, g, x: m_ep.apply(p, g, x))(
            params, stacked, xs_stacked)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, rtol=2e-5)


def test_trainer_ep_times_graph_is_refused(ds, tmp_path):
    """mp_axis > 1 together with graph_axis > 1 has no container that
    stacks partitioned graphs; the trainer says so instead of guessing."""
    cfg = preset("acm")
    cfg.data.graph_format = "csr"
    cfg.train.checkpoint_dir = str(tmp_path / "epg")
    cfg.mesh.mp_axis = 2
    cfg.mesh.graph_axis = 2
    with pytest.raises(ValueError, match="mp_axis"):
        Trainer(ds, cfg, logger=MetricLogger("", echo=False))


def test_trainer_ep_trajectory_matches_sequential(ds, tmp_path):
    """cfg.mesh.mp_axis=4 → Trainer stacks graphs + runs the EP model; the
    eval-mode losses match the sequential trainer given identical params —
    here checked end-to-end via deterministic training with dropout OFF."""
    def run(mp):
        cfg = preset("acm")
        cfg.model.hid_units = (8,)
        cfg.model.n_heads = (2, 1)
        cfg.model.attn_drop = 0.0
        cfg.model.ffd_drop = 0.0
        cfg.train.epochs = 3
        cfg.train.checkpoint_dir = str(tmp_path / f"mp{mp}")
        cfg.mesh.mp_axis = mp

        class Cap(MetricLogger):
            def __init__(self):
                super().__init__("", echo=False)
                self.rows = []

            def log(self, rec):
                self.rows.append(rec)

        cap = Cap()
        Trainer(ds, cfg, logger=cap).fit()
        return [r["val_loss"] for r in cap.rows if "val_loss" in r]

    seq, ep = run(1), run(4)
    # tower p draws its params from fold_in(key, p) in both layouts, so the
    # two runs start from the same params and must follow one trajectory
    assert len(seq) == len(ep) == 3
    assert all(np.isfinite(v) for v in seq + ep)
    np.testing.assert_allclose(ep, seq, rtol=2e-4, atol=2e-5)


def test_vmap_towers_dropout_fires(ds):
    """Training mode must reach the vmapped towers: with dropout on, the
    output changes against eval mode."""
    graphs = [metapath_to_csr(a) for a in ds.metapath_adjs]
    stacked = stack_graphs(graphs)
    x = jnp.asarray(ds.features)
    xs_stacked = jnp.stack([x] * len(graphs))
    m_ep = HAN(n_classes=3, hid_units=(8,), n_heads=(2, 1),
               vmap_towers=True, attn_drop=0.5, ffd_drop=0.5)
    params = m_ep.init(jax.random.PRNGKey(0), stacked, xs_stacked)
    eval_out = m_ep.apply(params, stacked, xs_stacked, deterministic=True)
    train_out = m_ep.apply(params, stacked, xs_stacked, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(7)})
    dev = float(jnp.abs(train_out[0] - eval_out[0]).max())
    assert dev > 1e-3, f"tower dropout did not fire under vmap (dev={dev})"
