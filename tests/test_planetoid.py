"""Planetoid loader (datasets/planetoid.py) against a synthetic fixture in
the exact on-disk format of reference utils/process.py:47-98 — pickled
x/y/tx/ty/allx/ally/graph shards + shuffled test.index reorder file,
including the citeseer isolated-test-node re-insertion path."""

import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from han_jax.datasets.planetoid import load_planetoid
from han_jax.datasets.registry import load_dataset


def write_fixture(root, name, *, n_train=8, n_val_extra=12, n_test=10,
                  n_feats=6, n_classes=3, gaps=()):
    """ind.<name>.* files. ``gaps``: test indices left OUT of tx/ty (the
    citeseer isolated-node case — loader must re-insert zero rows)."""
    rng = np.random.default_rng(3)
    n_allx = n_train + n_val_extra
    test_ids = np.arange(n_allx, n_allx + n_test)
    present = np.array([t for t in test_ids if t not in gaps])

    def onehot(m):
        y = np.zeros((m, n_classes))
        y[np.arange(m), rng.integers(0, n_classes, m)] = 1
        return y

    allx = sp.csr_matrix(rng.random((n_allx, n_feats)).astype(np.float32))
    x = allx[:n_train]
    ally = onehot(n_allx)
    y = ally[:n_train]
    # reference format (process.py:47-61): tx rows appear in test.index
    # FILE order — tx row i belongs to node test_index[i]. Rows encode
    # their node id as the f1/f0 ratio (invariant under the loader's row
    # normalization) so the reorder is checkable.
    shuffled = rng.permutation(present)
    tx_dense = np.zeros((len(present), n_feats), np.float32)
    tx_dense[:, 0] = 1.0
    tx_dense[:, 1] = shuffled / 100.0
    tx = sp.csr_matrix(tx_dense)
    ty = onehot(len(present))

    n = n_allx + n_test
    graph = {i: [] for i in range(n)}
    for _ in range(3 * n):
        u, v = rng.integers(0, n, 2)
        if u != v:
            graph[int(u)].append(int(v))
    for g in gaps:  # isolated test nodes have no edges
        graph[int(g)] = []
        for u in graph:
            graph[u] = [v for v in graph[u] if v != g]

    for key, obj in [("x", x), ("y", y), ("tx", tx), ("ty", ty),
                     ("allx", allx), ("ally", ally), ("graph", graph)]:
        with open(root / f"ind.{name}.{key}", "wb") as f:
            pickle.dump(obj, f)
    with open(root / f"ind.{name}.test.index", "w") as f:
        f.write("\n".join(str(int(i)) for i in shuffled) + "\n")
    return test_ids, present, shuffled


def test_planetoid_loads_and_reorders(tmp_path):
    test_ids, present, shuffled = write_fixture(tmp_path, "cora")
    ds = load_planetoid(tmp_path, "cora")
    n = 8 + 12 + 10
    assert ds.features.shape[0] == n and ds.labels.shape == (n, 3)
    assert len(ds.metapath_adjs) == 1
    a = ds.metapath_adjs[0]
    assert (a != a.T).nnz == 0 and a.diagonal().sum() == 0  # symmetric, no loops
    # masks: reference split — first |y| train, next 500 val, test from index
    assert ds.train_mask.sum() == 8
    assert ds.test_mask.sum() == 10
    assert not (ds.train_mask & ds.test_mask).any()
    # the tx shard arrives in SHUFFLED test.index order; after the loader's
    # reorder, row t must be the tx row that encoded id t (f1/f0 ratio is
    # invariant under row normalization)
    got_ids = 100.0 * ds.features[test_ids, 1] / ds.features[test_ids, 0]
    np.testing.assert_allclose(got_ids, test_ids, atol=1e-3)


def test_planetoid_citeseer_isolated_nodes(tmp_path):
    gaps = (24, 27)  # global test ids missing from tx/ty
    write_fixture(tmp_path, "citeseer", gaps=gaps)
    ds = load_planetoid(tmp_path, "citeseer")
    # isolated nodes re-inserted as zero feature/label rows (process.py:62-71)
    for g in gaps:
        assert ds.features[g].sum() == 0
        assert ds.labels[g].sum() == 0
    # they are still test nodes? reference keeps them OUT of test.index, so
    # the mask excludes them
    assert not ds.test_mask[list(gaps)].any()
    assert ds.test_mask.sum() == 8


def test_registry_and_trainer_smoke(tmp_path):
    write_fixture(tmp_path, "cora")
    ds = load_dataset("cora", root=tmp_path)
    assert ds.name == "cora"
    from han_jax.train.config import preset
    from han_jax.train.trainer import MetricLogger, Trainer

    cfg = preset("cora")
    assert cfg.model.arch == "gat"
    cfg.train.epochs = 2
    cfg.train.patience = 10
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.model.n_heads = (2, 1)

    class Cap(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)
            self.rows = []

        def log(self, rec):
            self.rows.append(rec)

    res = Trainer(ds, cfg, logger=Cap()).fit()
    assert np.isfinite(res["test_loss"])


def test_pubmed_preset_gat_on_flash(tmp_path):
    """pubmed preset = homogeneous GAT over the csr edge-domain backend."""
    write_fixture(tmp_path, "pubmed")
    ds = load_planetoid(tmp_path, "pubmed")
    from han_jax.train.config import preset
    from han_jax.train.trainer import MetricLogger, Trainer

    cfg = preset("pubmed")
    assert cfg.model.arch == "gat" and cfg.data.graph_format == "csr"
    cfg.train.epochs = 2
    cfg.train.patience = 10
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.model.n_heads = (2, 1)

    class Cap(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)
            self.rows = []

        def log(self, rec):
            self.rows.append(rec)

    res = Trainer(ds, cfg, logger=Cap()).fit()
    assert np.isfinite(res["test_loss"])
