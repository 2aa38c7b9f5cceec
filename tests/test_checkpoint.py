"""The pytree checkpoint module shared by the trainers: round trip of a
full training state, ``latest_step``, atomic re-saves and template checks."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from han_jax.train.checkpoint import CheckpointManager


def _state(scale=1.0):
    params = {"tower_0": {"GATConv_0": {"kernel": jnp.full((3, 2, 4), scale),
                                        "bias": jnp.zeros((2, 4))}},
              "classifier_0": {"kernel": jnp.arange(6.0).reshape(3, 2) * scale}}
    return {"params": params, "opt_state": optax.adam(1e-3).init(params),
            "rng": jax.random.PRNGKey(3), "epoch": jnp.asarray(7),
            "best_val_loss": jnp.asarray(0.25 * scale)}


def test_round_trip_restores_every_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    state = _state(2.0)
    mgr.save(7, state)
    got = mgr.restore(7, _state(0.0))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_latest_step_and_steps(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.latest_step() is None
    for step in (3, 12, 5):
        mgr.save(step, _state(float(step)))
    assert mgr.steps() == [3, 5, 12] and mgr.latest_step() == 12
    # a leftover temporary directory (a save killed midway) is not a step
    (tmp_path / "ck" / ".tmp-99-1").mkdir()
    assert mgr.latest_step() == 12
    assert float(mgr.restore(5, _state())["best_val_loss"]) == 1.25


def test_resave_replaces_step_whole(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(4, _state(1.0))
    mgr.save(4, _state(3.0))
    assert mgr.steps() == [4]
    assert float(mgr.restore(4, _state())["best_val_loss"]) == 0.75
    assert not any(p.name.startswith(".tmp") for p in (tmp_path / "ck").iterdir())


def test_restore_checks_the_template(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, _state())
    wrong_shape = _state()
    wrong_shape["params"]["classifier_0"]["kernel"] = jnp.zeros((2, 3))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, wrong_shape)
    extra = _state()
    extra["cursor"] = jnp.asarray(0)
    with pytest.raises(KeyError, match="cursor"):
        mgr.restore(1, extra)


def test_restore_places_leaves_like_the_template(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec

    from han_jax.parallel.mesh import make_mesh

    mesh = make_mesh(graph=4)
    repl = NamedSharding(mesh, PartitionSpec())
    template = jax.device_put(_state(), repl)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(2, jax.device_put(_state(5.0), repl))
    got = mgr.restore(2, template)
    leaf = got["params"]["classifier_0"]["kernel"]
    assert leaf.sharding == repl
    np.testing.assert_array_equal(np.asarray(leaf),
                                  np.arange(6.0).reshape(3, 2) * 5.0)
