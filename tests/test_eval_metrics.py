"""The numpy embedding-evaluation metrics against scikit-learn as an oracle
(scikit-learn is a test-only dependency)."""

import numpy as np
import pytest
from sklearn import metrics
from sklearn.cluster import KMeans
from sklearn.neighbors import KNeighborsClassifier

from han_jax.train import eval_embed as ee


def _labels(seed, n=150, c=4):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, c, n)
    b = np.where(rng.random(n) < 0.6, a, rng.integers(0, c + 1, n))
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_metrics_match_sklearn(seed):
    a, b = _labels(seed)
    assert ee.nmi(a, b) == pytest.approx(
        metrics.normalized_mutual_info_score(a, b), abs=1e-10)
    assert ee.ari(a, b) == pytest.approx(metrics.adjusted_rand_score(a, b),
                                         abs=1e-10)
    macro, micro = ee.f1_scores(a, b)
    assert macro == pytest.approx(
        metrics.f1_score(a, b, average="macro", zero_division=0), abs=1e-12)
    assert micro == pytest.approx(metrics.f1_score(a, b, average="micro"),
                                  abs=1e-12)


def test_partition_metric_edge_cases():
    a = np.array([0, 0, 1, 1, 2, 2])
    assert ee.nmi(a, a) == pytest.approx(1.0)
    assert ee.ari(a, a[::-1] * 0 + a) == 1.0
    one = np.zeros(6, int)
    assert ee.nmi(one, one) == metrics.normalized_mutual_info_score(one, one)
    assert ee.ari(one, a) == pytest.approx(metrics.adjusted_rand_score(one, a))
    assert ee.nmi(one, a) == pytest.approx(
        metrics.normalized_mutual_info_score(one, a))


@pytest.mark.parametrize("seed", [0, 1])
def test_silhouette_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((120, 6))
    lab = rng.integers(0, 4, 120)
    lab[0] = 9  # a singleton cluster scores 0
    assert ee.silhouette(x, lab) == pytest.approx(
        metrics.silhouette_score(x, lab), abs=1e-9)


def test_knn_predict_matches_sklearn():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 8))
    y = (x[:, 0] + 0.5 * rng.standard_normal(300) > 0).astype(int) + \
        (x[:, 1] > 0.5).astype(int)
    ref = KNeighborsClassifier(n_neighbors=5).fit(x[:200], y[:200]).predict(x[200:])
    got = ee.knn_predict(x[:200], y[:200], x[200:], k=5)
    np.testing.assert_array_equal(got, ref)


def test_kmeans_finds_sklearn_partition():
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((4, 10)) * 5
    y = np.repeat(np.arange(4), 60)
    x = centers[y] + rng.standard_normal((240, 10))
    ours = ee.kmeans(x, 4, seed=0)
    ref = KMeans(n_clusters=4, n_init=10, random_state=0).fit_predict(x)
    assert metrics.adjusted_rand_score(ours, ref) == 1.0
    out = ee.kmeans_eval(x, y, repeats=2, with_silhouette=True)
    assert out["nmi"] == pytest.approx(1.0) and out["ari"] == 1.0
    assert out["silhouette"] == pytest.approx(metrics.silhouette_score(x, ref))


def test_knn_eval_report_keys():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((80, 4))
    y = np.eye(3)[rng.integers(0, 3, 80)]  # one-hot labels are accepted
    out = ee.knn_eval(x, y, repeats=2, seed=1)
    assert sorted(out) == sorted(f"{m}_f1@{f}" for m in ("macro", "micro")
                                 for f in (0.2, 0.4, 0.6, 0.8))
    assert all(0.0 <= v <= 1.0 for v in out.values())
