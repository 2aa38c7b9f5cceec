"""Distributed tests on the virtual 8-device CPU mesh (SURVEY.md §4.5):
partition equivalence — the framework's key invariant — and the full
multi-device dry run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.build import metapath_to_csr
from han_jax.graph.synthetic import planted_hetero
from han_jax.nn.models import HAN
from han_jax.ops.attention import csr_attention
from han_jax.parallel.edge_partition import partition_csr
from han_jax.parallel.mesh import make_mesh
from han_jax.parallel.shard_attn import partitioned_attention

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def case(tiny_ds=None):
    ds = planted_hetero(n_nodes=70, n_feats=12, n_classes=3, n_metapaths=1,
                        avg_degree=6.0, train_per_class=8, n_val=8, seed=11)
    csr = metapath_to_csr(ds.metapath_adjs[0], edge_pad_to=32)
    rng = np.random.default_rng(4)
    n, k, d = csr.n_nodes, 4, 6
    fts = jnp.asarray(rng.standard_normal((n, k, d)).astype(np.float32))
    ld = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    ls = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    return ds, csr, fts, ld, ls


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (8, 1)])
def test_partition_equivalence(case, mesh_shape):
    """Edge-partitioned multi-device attention == single-device CSR result."""
    ds, csr, fts, ld, ls = case
    g, h = mesh_shape
    mesh = make_mesh(graph=g, heads=h)
    pg = partition_csr(csr, g, edge_pad_to=32)
    assert pg.n_edges == csr.n_edges
    ref = csr_attention(csr, fts, ld, ls)
    with jax.set_mesh(mesh):
        out = jax.jit(lambda f, a, b: partitioned_attention(pg, f, a, b))(fts, ld, ls)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_partition_balanced_boundaries(case):
    ds, csr, fts, ld, ls = case
    pg = partition_csr(csr, 4, balance_edges=True, edge_pad_to=32)
    # every real edge lands in exactly one shard
    total = sum(int((np.asarray(pg.col_idx[s]) < csr.n_nodes).sum())
                for s in range(4))
    assert total == csr.n_edges
    # perm is a bijection into the padded layout
    perm = np.asarray(pg.perm)
    assert len(np.unique(perm)) == csr.n_nodes


def test_partition_equivalence_grads(case):
    ds, csr, fts, ld, ls = case
    mesh = make_mesh(graph=4, heads=2)
    pg = partition_csr(csr, 4, edge_pad_to=32)

    def loss_single(f, a, b):
        return jnp.sum(csr_attention(csr, f, a, b) ** 2)

    def loss_sharded(f, a, b):
        return jnp.sum(partitioned_attention(pg, f, a, b) ** 2)

    g_ref = jax.grad(loss_single, argnums=(0, 1, 2))(fts, ld, ls)
    with jax.set_mesh(mesh):
        g_shard = jax.jit(jax.grad(loss_sharded, argnums=(0, 1, 2)))(fts, ld, ls)
    for a, b in zip(g_ref, g_shard):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=5e-5, rtol=5e-5)


def test_full_model_partition_equivalence(case):
    """Whole HAN forward: sharded graphs vs single-device CSR graphs."""
    ds, csr, *_ = case
    x = jnp.asarray(ds.features)
    model = HAN(n_classes=ds.n_classes, hid_units=(8,), n_heads=(4, 1),
                semantic_dim=16)
    params = model.init(jax.random.PRNGKey(0), [csr], [x])
    ref_logits, ref_embed, ref_alphas = model.apply(params, [csr], [x])

    mesh = make_mesh(graph=4, heads=2)
    pg = partition_csr(csr, 4, edge_pad_to=32)
    with jax.set_mesh(mesh):
        out = jax.jit(lambda p: model.apply(p, [pg], [x]))(params)
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref_logits),
                               atol=1e-4, rtol=1e-3)


def test_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_dryrun_equivalence_gate_can_fail(monkeypatch):
    """Mutation check on the cross-backend equivalence gate:
    perturb ONE backend's attention logits and assert run_dryrun's
    deterministic-loss assertion actually fires. Guards the guard — a
    det_max_dev that reads 0.0 is only meaningful if it can read nonzero."""
    from han_jax.parallel import dryrun, shard_attn

    real = shard_attn._local_csr_attention
    # csr backend only: scale that backend's aggregated output — the
    # ring backend is untouched, so det losses must diverge
    monkeypatch.setattr(
        shard_attn, "_local_csr_attention",
        lambda *a, **kw: real(*a, **kw) * 1.5)
    with pytest.raises(AssertionError, match="disagree"):
        dryrun.run_dryrun(8)


def test_launch_single_process_noop():
    """init_distributed with no configuration is a no-op that still reports
    the local topology (SURVEY.md §5.8 launcher)."""
    from han_jax.parallel.launch import init_distributed, is_coordinator

    info = init_distributed()
    assert info["num_processes"] == 1 and info["process_id"] == 0
    assert info["global_devices"] >= 1
    assert is_coordinator()


@pytest.mark.parametrize("name", ["HAN_OLD_COORDINATOR", "HAN_X_NUM_PROCESSES",
                                  "HAN_X_PROCESS_ID"])
def test_launch_refuses_unread_coordinate_variables(monkeypatch, name):
    """A launcher that sets coordinates under another HAN_* name fails
    loudly instead of leaving each host a single-process job."""
    from han_jax.parallel.launch import init_distributed

    monkeypatch.setenv(name, "localhost:1234" if "COORD" in name else "2")
    with pytest.raises(RuntimeError, match=name):
        init_distributed()
