"""Seeded synthetic heterogeneous graph generators.

Two roles:

1. **Fixture graphs** standing in for the missing ACM3025 ``.mat`` blob
   (reference ``.MISSING_LARGE_BLOBS``): same shapes/splits as the real
   dataset, with planted community structure so the semi-supervised task is
   learnable and accuracy targets are meaningful.
2. **Scale benchmarks**: power-law heterogeneous graphs up to the
   BASELINE.json synthetic 100M-edge config, generated shard-by-shard so the
   host never materializes more than one partition.

Everything is deterministic in the given seed (no wall-clock entropy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from han_jax.graph.build import symmetric_metapath


@dataclasses.dataclass
class HeteroDataset:
    """In-memory heterogeneous node-classification dataset (host arrays)."""

    metapath_adjs: list[sp.csr_matrix]  # P square N×N meta-path graphs (no self-loops implied)
    features: np.ndarray  # float32[N, F]
    labels: np.ndarray  # float32[N, C] one-hot
    train_mask: np.ndarray  # bool[N]
    val_mask: np.ndarray
    test_mask: np.ndarray
    name: str = "synthetic"
    metapath_names: tuple[str, ...] = ()

    @property
    def n_nodes(self) -> int:
        return int(self.features.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.labels.shape[1])


def planted_hetero(
    *,
    n_nodes: int = 3025,
    n_feats: int = 1870,
    n_classes: int = 3,
    n_metapaths: int = 2,
    avg_degree: float = 10.0,
    homophily: float = 0.85,
    feat_signal: float = 1.5,
    train_per_class: int = 200,
    n_val: int = 300,
    n_communities: int | None = None,
    shuffle_nodes: bool = False,
    seed: int = 0,
    name: str = "synthetic",
) -> HeteroDataset:
    """Planted-partition heterogeneous graph with *clustered* cross edges.

    Nodes belong to ``n_communities`` contiguous communities (default
    4 × n_classes); class = community mod n_classes. A fraction
    ``homophily`` of each node's edges stay inside its community; the rest
    go to the two ring-adjacent communities — matching the locality of real
    meta-path graphs (most cross-community citations/co-authorships touch a
    few related areas, not uniformly random nodes). With the default
    contiguous layout the adjacency is block-tridiagonal-ish;
    ``shuffle_nodes=True`` destroys the layout.

    Defaults mirror the ACM3025 shape (3025 nodes / 1870 feats / 3 classes /
    2 meta-paths / 600-300-2125 split — han.pdf Table 2).
    """
    rng = np.random.default_rng(seed)
    n_comm = n_communities or max(4 * n_classes, 8)
    comm = (np.arange(n_nodes) * n_comm) // n_nodes  # contiguous communities
    y = comm % n_classes

    # community member lists for targeted sampling
    members = [np.where(comm == c)[0] for c in range(n_comm)]

    adjs = []
    for p in range(n_metapaths):
        # per-metapath homophily varies a bit so semantic attention has signal
        h = homophily if p == 0 else max(0.55, homophily - 0.2 * p)
        n_edges = int(n_nodes * avg_degree / 2)
        src = rng.integers(0, n_nodes, size=n_edges)
        stay = rng.random(n_edges) < h
        ring = rng.integers(0, 2, size=n_edges) * 2 - 1  # ±1 neighbor community
        dst_comm = np.where(stay, comm[src], (comm[src] + ring) % n_comm)
        # sample a uniform member of the destination community
        sizes = np.array([m.shape[0] for m in members])
        offs = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        flat = np.concatenate(members)
        dst = flat[offs[dst_comm] + rng.integers(0, 1 << 30, size=n_edges) % sizes[dst_comm]]
        a = sp.coo_matrix(
            (np.ones(n_edges, dtype=np.float32), (src, dst)),
            shape=(n_nodes, n_nodes))
        a = ((a + a.T) > 0).astype(np.float32).tocsr()
        a.setdiag(0)
        a.eliminate_zeros()
        adjs.append(a)

    # class-structured sparse features
    feats = (rng.random((n_nodes, n_feats)) < 0.02).astype(np.float32)
    block = n_feats // n_classes
    for cidx in range(n_classes):
        members = np.where(y == cidx)[0]
        lo, hi = cidx * block, (cidx + 1) * block
        boost = (rng.random((members.shape[0], hi - lo)) < 0.02 * feat_signal).astype(np.float32)
        feats[members[:, None], np.arange(lo, hi)[None, :]] += boost
    feats = np.minimum(feats, 1.0)

    labels = np.zeros((n_nodes, n_classes), dtype=np.float32)
    labels[np.arange(n_nodes), y] = 1.0

    train_mask = np.zeros(n_nodes, dtype=bool)
    for cidx in range(n_classes):
        members = np.where(y == cidx)[0]
        pick = rng.permutation(members)[:train_per_class]
        train_mask[pick] = True
    rest = np.where(~train_mask)[0]
    rest = rng.permutation(rest)
    val_mask = np.zeros(n_nodes, dtype=bool)
    val_mask[rest[:n_val]] = True
    test_mask = np.zeros(n_nodes, dtype=bool)
    test_mask[rest[n_val:]] = True

    if shuffle_nodes:
        perm = rng.permutation(n_nodes)
        adjs = [a.tocsr()[perm][:, perm] for a in adjs]
        feats = feats[perm]
        labels = labels[perm]
        train_mask = train_mask[perm]
        val_mask = val_mask[perm]
        test_mask = test_mask[perm]

    return HeteroDataset(
        metapath_adjs=adjs,
        features=feats,
        labels=labels,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name=name,
        metapath_names=tuple(f"MP{p}" for p in range(n_metapaths)),
    )


def powerlaw_bipartite(
    n_left: int,
    n_right: int,
    n_edges: int,
    *,
    alpha: float = 1.5,
    seed: int = 0,
) -> sp.csr_matrix:
    """Power-law bipartite incidence (e.g. paper→author) for scale tests.

    Right-node popularity follows a Zipf-like distribution with exponent
    ``alpha`` — models the degree skew called out in SURVEY.md §7 (conference
    nodes with ~14k papers in DBLP APCPA).
    """
    rng = np.random.default_rng(seed)
    popularity = 1.0 / np.arange(1, n_right + 1, dtype=np.float64) ** alpha
    popularity /= popularity.sum()
    src = rng.integers(0, n_left, size=n_edges)
    dst = rng.choice(n_right, size=n_edges, p=popularity)
    m = sp.coo_matrix(
        (np.ones(n_edges, dtype=np.float32), (src, dst)), shape=(n_left, n_right)
    ).tocsr()
    m.sum_duplicates()
    m.data = np.ones_like(m.data)
    return m


def powerlaw_hetero(
    *,
    n_nodes: int = 100_000,
    n_feats: int = 128,
    n_classes: int = 8,
    edges_per_metapath: int = 2_000_000,
    n_metapaths: int = 2,
    seed: int = 0,
) -> HeteroDataset:
    """Large synthetic heterogeneous graph via meta-path composition over
    power-law bipartite incidences (the BASELINE.json 100M-edge config scaled
    by arguments)."""
    rng = np.random.default_rng(seed)
    adjs = []
    for p in range(n_metapaths):
        n_mid = max(64, n_nodes // (8 * (p + 1)))
        inc = powerlaw_bipartite(
            n_nodes, n_mid, edges_per_metapath // 4, alpha=1.2 + 0.2 * p, seed=seed + 13 * p
        )
        a = symmetric_metapath(inc)
        a.setdiag(0)
        a.eliminate_zeros()
        adjs.append(a)
    y = rng.integers(0, n_classes, size=n_nodes)
    feats = rng.standard_normal((n_nodes, n_feats)).astype(np.float32)
    labels = np.zeros((n_nodes, n_classes), dtype=np.float32)
    labels[np.arange(n_nodes), y] = 1.0
    train_mask = rng.random(n_nodes) < 0.1
    val_mask = (~train_mask) & (rng.random(n_nodes) < 0.1)
    test_mask = ~(train_mask | val_mask)
    return HeteroDataset(
        metapath_adjs=adjs,
        features=feats,
        labels=labels,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name="powerlaw",
        metapath_names=tuple(f"PL{p}" for p in range(n_metapaths)),
    )


# DBLP four-area shape (han.pdf Table 2; BASELINE.md): 4,057 authors with
# 334 keyword features in 4 areas, 20 conferences (5 per area) and 7,723
# terms; 800/400 train/val, rest test.
DBLP_SHAPE = dict(n_nodes=4057, n_feats=334, n_classes=4, n_conferences=20,
                  n_terms=7723, n_train=800, n_val=400)
# real class proportions (DB 1197, DM 745, AI 1109, IR 1006)
_DBLP_CLASS_P = np.array([1197, 745, 1109, 1006]) / 4057


def _incidence(rng, n_rows, n_cols, extra_per_row, pop, own_cols=None,
               own_prob=0.0) -> sp.csr_matrix:
    """Binary row→column incidence: each row links 1 + Poisson(extra) columns
    drawn by popularity ``pop``; with ``own_cols`` a share ``own_prob`` of
    them comes from the row's own column group instead."""
    m = 1 + rng.poisson(extra_per_row, n_rows)
    rows = np.repeat(np.arange(n_rows), m)
    cols = rng.choice(n_cols, size=rows.size, p=pop / pop.sum())
    if own_cols is not None:
        group = own_cols.shape[1]
        own = own_cols[rows, rng.integers(0, group, size=rows.size)]
        cols = np.where(rng.random(rows.size) < own_prob, own, cols)
    inc = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                        shape=(n_rows, n_cols))
    inc.data[:] = 1.0
    return inc


def dblp_shaped(*, seed: int = 0, n_nodes: int = 4057, n_train: int = 800,
                n_val: int = 400) -> HeteroDataset:
    """Seeded stand-in for the DBLP four-area task (the raw files are not
    shipped): authors with APA / APCPA / APTPA meta-paths built by
    composing author→paper-venue and author→term incidences, so the
    meta-path graphs have DBLP's densities and skew — at 4,057 authors
    APA ≈ 11.1k, APCPA ≈ 5.0M and APTPA ≈ 12.9M edges counting the
    self-loops the models add (han.pdf Table 2). A smaller ``n_nodes``
    keeps the densities, so edge counts shrink with n_nodes².

    Authors favour their area's conferences (homophily ~0.5 on APCPA), terms
    follow a Zipf(0.8) popularity, and co-authorship (APA) is a sparse
    homophilous graph of ~0.87 pairs per author; features are 334 binary
    keywords with a class-dependent block.
    """
    shape = DBLP_SHAPE
    rng = np.random.default_rng(seed)
    n_classes, n_conf = shape["n_classes"], shape["n_conferences"]
    y = rng.choice(n_classes, size=n_nodes, p=_DBLP_CLASS_P)

    # APA: co-authorship pairs, mostly within an area
    n_pairs = int(round(0.8697 * n_nodes))
    src = rng.integers(0, n_nodes, size=n_pairs)
    same = rng.random(n_pairs) < 0.85
    by_class = [np.where(y == c)[0] for c in range(n_classes)]
    dst = np.array([rng.choice(by_class[y[s]]) if keep else rng.integers(n_nodes)
                    for s, keep in zip(src, same)], dtype=np.int64)
    apa = sp.coo_matrix((np.ones(n_pairs, np.float32), (src, dst)),
                        shape=(n_nodes, n_nodes))

    # APCPA: authors meet at conferences, 5 per area
    area_confs = np.arange(n_conf).reshape(n_classes, -1)
    a_conf = _incidence(rng, n_nodes, n_conf, 2.2, np.ones(n_conf),
                        own_cols=area_confs[y], own_prob=0.7)
    # APTPA: authors share title terms of Zipf popularity
    n_terms = shape["n_terms"]
    a_term = _incidence(rng, n_nodes, n_terms, 24.6,
                        1.0 / np.arange(1, n_terms + 1) ** 0.8)

    adjs = []
    for a in (apa.tocsr(), a_conf @ a_conf.T, a_term @ a_term.T):
        a = ((a + a.T) > 0).astype(np.float32).tocsr()
        a.setdiag(0)
        a.eliminate_zeros()
        adjs.append(a)

    # binary keyword features with a class-dependent block
    n_feats = shape["n_feats"]
    feats = (rng.random((n_nodes, n_feats)) < 0.02).astype(np.float32)
    block = n_feats // n_classes
    cols = (y[:, None] * block + np.arange(block)[None, :])
    boost = rng.random((n_nodes, block)) < 0.05
    feats[np.arange(n_nodes)[:, None], cols] = np.maximum(
        feats[np.arange(n_nodes)[:, None], cols], boost)

    labels = np.zeros((n_nodes, n_classes), np.float32)
    labels[np.arange(n_nodes), y] = 1.0
    # class-balanced train then val, rest test (preprocess_dblp.py split_idx)
    train_mask = np.zeros(n_nodes, bool)
    val_mask = np.zeros(n_nodes, bool)
    for c in range(n_classes):
        members = rng.permutation(by_class[c])
        t, v = n_train // n_classes, n_val // n_classes
        train_mask[members[:t]] = True
        val_mask[members[t:t + v]] = True
    test_mask = ~(train_mask | val_mask)
    return HeteroDataset(
        metapath_adjs=adjs, features=feats, labels=labels,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        name="dblp_shaped", metapath_names=("APA", "APCPA", "APTPA"))


def community_csr(n: int, avg_degree: int, *, n_comm: int = 64,
                  seed: int = 0) -> sp.csr_matrix:
    """Fixed-degree CSR with 80% of each row's neighbors inside its
    community, built directly from index arrays (no COO duplicates, no
    dense forms) — cheap at 100M edges."""
    rng = np.random.default_rng(seed)
    row_ptr = np.arange(n + 1, dtype=np.int64) * avg_degree
    comm_of = (np.arange(n, dtype=np.int64) * n_comm) // n
    comm_size = n // n_comm
    cols = ((comm_of * comm_size)[:, None]
            + rng.integers(0, max(comm_size, 1), size=(n, avg_degree)))
    far = rng.random((n, avg_degree)) > 0.8
    cols[far] = rng.integers(0, n, size=int(far.sum()))
    cols = np.minimum(cols, n - 1).astype(np.int32).reshape(-1)
    return sp.csr_matrix((np.ones(cols.shape[0], np.float32), cols, row_ptr),
                         shape=(n, n))


def scale_hetero(*, n_nodes: int = 500_000, avg_degree: int = 100,
                 n_metapaths: int = 2, n_feats: int = 64, n_classes: int = 8,
                 n_train: int = 512 * 30, n_val: int = 512,
                 seed: int = 0) -> HeteroDataset:
    """The sampled-training scale graph (BASELINE.json "synthetic 100M-edge
    heterogeneous graph"): ``n_metapaths`` community CSRs of fixed degree,
    Gaussian features, uniform labels; the first ``n_train`` nodes train
    and the last ``n_val`` validate."""
    rng = np.random.default_rng(seed)
    adjs = [community_csr(n_nodes, avg_degree, seed=seed + 31 * p)
            for p in range(n_metapaths)]
    feats = rng.standard_normal((n_nodes, n_feats), dtype=np.float32)
    labels = np.zeros((n_nodes, n_classes), np.float32)
    labels[np.arange(n_nodes), rng.integers(0, n_classes, size=n_nodes)] = 1.0
    train_mask = np.zeros(n_nodes, bool)
    train_mask[:n_train] = True
    val_mask = np.zeros(n_nodes, bool)
    val_mask[-n_val:] = True
    return HeteroDataset(adjs, feats, labels, train_mask, val_mask,
                         ~(train_mask | val_mask), name="scale",
                         metapath_names=tuple(f"S{p}" for p in range(n_metapaths)))
