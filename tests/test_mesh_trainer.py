"""Mesh-driven full-graph Trainer: cfg.mesh builds the ('graph','heads')
mesh, graphs become PartitionedCSR, and the SAME trainer/model code trains
multi-device on sharded segment ops — with the loss trajectory matching
the single-device run (dropout off: the sharded backend draws its own
per-shard masks)."""

import numpy as np
import pytest

from han_jax.graph.synthetic import planted_hetero
from han_jax.train.config import preset
from han_jax.train.trainer import MetricLogger, Trainer


class Capture(MetricLogger):
    def __init__(self):
        super().__init__("", echo=False)
        self.rows = []

    def log(self, rec):
        self.rows.append(rec)


@pytest.fixture(scope="module")
def ds():
    return planted_hetero(n_nodes=300, n_feats=24, n_classes=3, n_metapaths=2,
                          avg_degree=8.0, train_per_class=20, n_val=30, seed=11)


def _cfg(tmp_path, graph_axis=1, head_axis=1, dropout=0.0, epochs=4):
    cfg = preset("acm")
    cfg.data.graph_format = "csr"
    cfg.model.hid_units = (8,)
    cfg.model.n_heads = (4, 1)
    cfg.model.attn_drop = dropout
    cfg.model.ffd_drop = dropout
    cfg.train.epochs = epochs
    cfg.train.patience = 100
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.mesh.graph_axis = graph_axis
    cfg.mesh.head_axis = head_axis
    return cfg


def _train(ds, cfg):
    cap = Capture()
    Trainer(ds, cfg, logger=cap).fit()
    return [(r["train_loss"], r["val_loss"]) for r in cap.rows
            if "train_loss" in r]


def test_mesh_trainer_matches_single_device(ds, tmp_path):
    ref = _train(ds, _cfg(tmp_path / "s"))
    for ga, ha in ((4, 1), (2, 2)):
        got = _train(ds, _cfg(tmp_path / f"m{ga}{ha}", ga, ha))
        assert len(got) == len(ref)
        # same math, only the segment-sum order across shards differs →
        # tight tolerance
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5)


def test_mesh_trainer_builds_partitioned_graphs(ds, tmp_path):
    t = Trainer(ds, _cfg(tmp_path / "p", 4, 1), logger=Capture())
    assert type(t.graphs[0]).__name__ == "PartitionedCSR"
    assert t.graphs[0].n_shards == 4
    assert t.mesh is not None and dict(
        zip(t.mesh.axis_names, t.mesh.devices.shape)) == {"graph": 4, "heads": 1}


def test_mesh_trainer_trains_with_dropout(ds, tmp_path):
    """graph=4 with the reference's 0.6 attention and feature dropout (each
    shard draws its own coefficient masks): finite losses that fall."""
    got = np.asarray(_train(ds, _cfg(tmp_path, 4, 1, dropout=0.6, epochs=8)))
    assert got.shape == (8, 2) and np.all(np.isfinite(got))
    assert got[-1, 0] < got[0, 0] and got[-1, 1] < got[0, 1]
