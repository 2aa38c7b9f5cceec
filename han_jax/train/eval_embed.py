"""Downstream embedding evaluation: KNN classification + KMeans clustering.

Reference: jhyexp.py:20-52 (``my_KNN``) and :54-86 (``my_Kmeans``). Fixed
here (SURVEY.md §7 defect list): cluster count defaults to the true number
of classes instead of the hard-coded 4, and the broken ``jhyexps`` import
(ex_acm3025.py:288) does not exist — this module is the real import path.

Everything is plain numpy, with scikit-learn's definitions: k-NN with
uniform votes (ties to the smaller label), k-means++ seeding with greedy
local trials and Lloyd iterations, F1 with zero-division scored 0,
arithmetic-mean NMI, pair-counting ARI and the euclidean silhouette.
"""

from __future__ import annotations

import numpy as np


def _sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared euclidean distances (len(a), len(b)), clipped at 0."""
    d = (np.sum(a * a, axis=1)[:, None] - 2.0 * a @ b.T
         + np.sum(b * b, axis=1)[None, :])
    return np.maximum(d, 0.0)


def knn_predict(x_train, y_train, x_test, k: int = 5) -> np.ndarray:
    """Majority label of the k nearest training rows (ties → smaller label)."""
    x_train = np.asarray(x_train, np.float64)
    x_test = np.asarray(x_test, np.float64)
    y_train = np.asarray(y_train)
    k = min(k, x_train.shape[0])
    nearest = np.argsort(_sq_dists(x_test, x_train), axis=1, kind="stable")[:, :k]
    labels = np.unique(y_train)
    votes = (y_train[nearest][:, :, None] == labels[None, None, :]).sum(axis=1)
    return labels[np.argmax(votes, axis=1)]


def f1_scores(y_true, y_pred) -> tuple[float, float]:
    """(macro, micro) F1 over the labels present in either array."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], float)
    fp = np.array([np.sum((y_true != c) & (y_pred == c)) for c in labels], float)
    fn = np.array([np.sum((y_true == c) & (y_pred != c)) for c in labels], float)
    denom = 2 * tp + fp + fn
    per_class = np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    total = 2 * tp.sum() + fp.sum() + fn.sum()
    micro = 2 * tp.sum() / total if total > 0 else 0.0
    return float(per_class.mean()), float(micro)


def _contingency(a, b) -> np.ndarray:
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)
    return table


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0] / counts.sum()
    return float(-np.sum(p * np.log(p)))


def nmi(y_true, y_pred) -> float:
    """Normalized mutual information, arithmetic-mean normalization."""
    table = _contingency(y_true, y_pred)
    if table.shape[0] == table.shape[1] == 1:
        return 1.0
    n = table.sum()
    rows, cols = table.sum(axis=1), table.sum(axis=0)
    nz = table > 0
    pij = table[nz] / n
    mi = float(np.sum(pij * (np.log(table[nz] * n)
                             - np.log(np.outer(rows, cols)[nz]))))
    if mi <= 0.0:
        return 0.0
    return mi / ((_entropy(rows) + _entropy(cols)) / 2.0)


def ari(y_true, y_pred) -> float:
    """Adjusted Rand index from the pair confusion matrix."""
    table = _contingency(y_true, y_pred).astype(np.float64)
    n = table.sum()
    sum_sq = np.sum(table ** 2)
    rows, cols = table.sum(axis=1), table.sum(axis=0)
    tp = sum_sq - n
    fp = np.sum(cols ** 2) - sum_sq
    fn = np.sum(rows ** 2) - sum_sq
    tn = n ** 2 - fp - fn - sum_sq
    if fn == 0 and fp == 0:
        return 1.0
    return float(2.0 * (tp * tn - fn * fp)
                 / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)))


def silhouette(x, labels) -> float:
    """Mean euclidean silhouette; members of singleton clusters score 0."""
    x = np.asarray(x, np.float64)
    labels = np.asarray(labels)
    uniq, inv = np.unique(labels, return_inverse=True)
    if not 2 <= uniq.size <= x.shape[0] - 1:
        raise ValueError(f"silhouette needs 2..n-1 clusters, got {uniq.size}")
    dist = np.sqrt(_sq_dists(x, x))
    np.fill_diagonal(dist, 0.0)
    onehot = np.eye(uniq.size)[inv]                       # (n, C)
    sums = dist @ onehot                                  # (n, C)
    sizes = onehot.sum(axis=0)
    own = sizes[inv]
    a = np.divide(sums[np.arange(len(x)), inv], own - 1,
                  out=np.zeros(len(x)), where=own > 1)
    other = np.where(onehot > 0, np.inf, sums / sizes[None, :])
    b = other.min(axis=1)
    s = np.where(own > 1, (b - a) / np.maximum(np.maximum(a, b), 1e-300), 0.0)
    return float(s.mean())


def _kmeans_pp(x, k, rng) -> np.ndarray:
    """Greedy k-means++ seeding (2 + log k candidates per new center)."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = [x[rng.integers(n)]]
    closest = _sq_dists(x, centers[0][None])[:, 0]
    for _ in range(1, k):
        total = closest.sum()
        if total <= 0:
            cand = rng.integers(n, size=trials)
        else:
            cand = np.searchsorted(np.cumsum(closest), rng.random(trials) * total)
            cand = np.minimum(cand, n - 1)
        cand_d = np.minimum(closest[None, :], _sq_dists(x[cand], x))
        best = int(np.argmin(cand_d.sum(axis=1)))
        centers.append(x[cand[best]])
        closest = cand_d[best]
    return np.stack(centers)


def kmeans(x, k: int, *, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4, seed: int = 0) -> np.ndarray:
    """Lloyd k-means, best inertia of ``n_init`` k-means++ starts."""
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    tol = tol * float(np.mean(np.var(x, axis=0)))
    best_labels, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = _kmeans_pp(x, k, rng)
        for _ in range(max_iter):
            labels = np.argmin(_sq_dists(x, centers), axis=1)
            new = centers.copy()
            for c in range(k):
                members = labels == c
                if members.any():
                    new[c] = x[members].mean(axis=0)
            shift = float(np.sum((new - centers) ** 2))
            centers = new
            if shift <= tol:
                break
        d = _sq_dists(x, centers)
        labels = np.argmin(d, axis=1)
        inertia = float(d[np.arange(len(x)), labels].sum())
        if inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels


def knn_eval(
    x: np.ndarray,
    y: np.ndarray,
    *,
    k: int = 5,
    split_list=(0.2, 0.4, 0.6, 0.8),
    repeats: int = 10,
    seed: int = 0,
) -> dict[str, float]:
    """k-NN classification over the frozen embedding at several train
    fractions, averaged over shuffled repeats; returns
    {'macro_f1@0.2': ..., 'micro_f1@0.2': ..., ...}."""
    x = np.asarray(x)
    y = np.asarray(y)
    if y.ndim > 1:
        y = np.argmax(y, axis=1)
    rng = np.random.default_rng(seed)
    out: dict[str, float] = {}
    for frac in split_list:
        split = int(x.shape[0] * frac)
        macro, micro = [], []
        for _ in range(repeats):
            perm = rng.permutation(x.shape[0])
            xp, yp = x[perm], y[perm]
            pred = knn_predict(xp[:split], yp[:split], xp[split:], k=k)
            ma, mi = f1_scores(yp[split:], pred)
            macro.append(ma)
            micro.append(mi)
        out[f"macro_f1@{frac}"] = float(np.mean(macro))
        out[f"micro_f1@{frac}"] = float(np.mean(micro))
    return out


def kmeans_eval(
    x: np.ndarray,
    y: np.ndarray,
    *,
    n_clusters: int | None = None,
    repeats: int = 10,
    seed: int = 0,
    with_silhouette: bool = False,
) -> dict[str, float]:
    """KMeans clustering of the embedding; NMI + ARI averaged over repeats.
    ``n_clusters`` defaults to the number of distinct labels.
    ``with_silhouette`` adds the euclidean silhouette score of the cluster
    assignment (the data/exp.py:25-63 ``my_Kmeans`` variant)."""
    x = np.asarray(x)
    y = np.asarray(y)
    if y.ndim > 1:
        y = np.argmax(y, axis=1)
    k = int(n_clusters or len(np.unique(y)))
    scores_nmi, scores_ari, sil = [], [], []
    for r in range(repeats):
        pred = kmeans(x, k, n_init=10, seed=seed + r)
        scores_nmi.append(nmi(y, pred))
        scores_ari.append(ari(y, pred))
        if with_silhouette:
            sil.append(silhouette(x, pred))
    out = {"nmi": float(np.mean(scores_nmi)), "ari": float(np.mean(scores_ari))}
    if with_silhouette:
        out["silhouette"] = float(np.mean(sil))
    return out
