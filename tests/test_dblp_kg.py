"""HIN→KG export + term cleanup (SURVEY.md C15/C16) against the real raw
DBLP four-area files shipped with the reference, plus the silhouette
kmeans variant and confusion-matrix metric."""

import pickle

import numpy as np
import pytest

from han_jax.datasets.base import REFERENCE_DATA
from han_jax.datasets.dblp_kg import clean_terms, hin_to_kg

DBLP = REFERENCE_DATA / "DBLP_four_area"
needs_dblp = pytest.mark.skipif(
    not (DBLP / "author.txt").exists(), reason="raw DBLP files unavailable")


@needs_dblp
def test_hin_to_kg_counts_and_format(tmp_path):
    ents, rels, trips = hin_to_kg(out_dir=tmp_path)
    # node counts from data/DBLP_four_area (SURVEY.md C17)
    assert len(ents) == 14475 + 14376 + 8920 + 20
    assert rels == ["PA", "PC", "PT"]
    assert len(trips) == 41794 + 14376 + 114624
    # type-prefixed ids, (head, tail, rel) ordering
    assert ents[0].startswith("A") and ents[-1].startswith("C")
    h, t, r = trips[0]
    assert h.startswith("P") and t.startswith("A") and r == "PA"
    # pickle round-trips the exact triple list
    with open(tmp_path / "DBLP_Triplets.pickle", "rb") as f:
        e2, r2, t2 = pickle.load(f)
    assert e2 == ents and t2 == trips
    # FB15K-style sidecar files line up
    lines = (tmp_path / "entity2id.txt").read_text().splitlines()
    assert len(lines) == len(ents) and lines[0] == f"{ents[0]}\t0"
    assert len((tmp_path / "train.txt").read_text().splitlines()) == len(trips)


@needs_dblp
def test_clean_terms_filters_stopwords(tmp_path):
    counts = clean_terms(out_dir=tmp_path)
    assert counts["terms_dropped"] > 0  # raw term.txt does contain stopwords
    assert counts["terms_kept"] + counts["terms_dropped"] == 8920
    kept_ids = {l.split("\t")[0]
                for l in (tmp_path / "term_modify.txt").read_text().splitlines()}
    assert len(kept_ids) == counts["terms_kept"]
    # every surviving paper_term link points at a surviving term
    for line in (tmp_path / "paper_term_modify.txt").read_text().splitlines()[:1000]:
        assert line.split("\t")[1] in kept_ids
    # explicit stopword list is honored
    c2 = clean_terms(stopwords={"data"})
    assert c2["terms_dropped"] == 1


def test_kmeans_eval_silhouette():
    from han_jax.train.eval_embed import kmeans_eval

    rng = np.random.default_rng(0)
    # two well-separated blobs → high NMI and positive silhouette
    x = np.concatenate([rng.normal(0, 0.1, (40, 8)), rng.normal(5, 0.1, (40, 8))])
    y = np.repeat([0, 1], 40)
    out = kmeans_eval(x, y, repeats=2, with_silhouette=True)
    assert out["nmi"] > 0.99 and out["silhouette"] > 0.8
    assert "silhouette" not in kmeans_eval(x, y, repeats=1)


def test_confusion_matrix_matches_sklearn():
    import sklearn.metrics

    from han_jax.nn.losses import confusion_matrix

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((50, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 50)
    ours = np.asarray(confusion_matrix(logits, labels, 4))
    ref = sklearn.metrics.confusion_matrix(
        labels, logits.argmax(-1), labels=range(4))
    np.testing.assert_array_equal(ours, ref)
