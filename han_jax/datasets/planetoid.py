"""Planetoid citation-graph loader (cora / citeseer / pubmed).

Format and semantics follow the reference ``utils/process.py:47-98``
(tkipf/gcn lineage): pickled ``x/y/tx/ty/allx/ally/graph`` shards plus a
test-index reorder file, with the citeseer isolated-node fix. Returns the
standard homogeneous semi-supervised task (single adjacency == one
"meta-path", so it plugs into the same GAT/HAN pipeline).
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np
import scipy.sparse as sp

from han_jax.datasets.base import HeteroDataset
from han_jax.graph.build import row_normalize_features


def load_planetoid(root: str | pathlib.Path, name: str) -> HeteroDataset:
    root = pathlib.Path(root)
    keys = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    objs = []
    for k in keys:
        with open(root / f"ind.{name}.{k}", "rb") as f:
            objs.append(pickle.load(f, encoding="latin1"))
    x, y, tx, ty, allx, ally, graph = objs

    test_idx = np.array([int(line.strip())
                         for line in open(root / f"ind.{name}.test.index")])
    test_range = np.sort(test_idx)

    if name == "citeseer":
        # isolated test nodes: re-insert as zero rows (process.py:62-71)
        full = range(int(test_idx.min()), int(test_idx.max()) + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_range - test_range.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_range - test_range.min(), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_range, :]
    labels = np.vstack((ally, ty))
    labels[test_idx, :] = labels[test_range, :]

    n = labels.shape[0]
    rows, cols = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
    adj = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                        shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.float32).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()

    train_mask = np.zeros(n, bool)
    train_mask[: y.shape[0]] = True
    val_mask = np.zeros(n, bool)
    val_mask[y.shape[0]: y.shape[0] + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_range] = True

    return HeteroDataset(
        metapath_adjs=[adj],
        features=np.asarray(row_normalize_features(features.toarray()),
                            dtype=np.float32),
        labels=labels.astype(np.float32),
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name=name,
        metapath_names=("CITES",),
    )
