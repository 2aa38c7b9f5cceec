"""DBLP heterogeneous-information-network export + term cleanup tools.

Covers the two standalone preprocessing scripts shipped with the reference
(SURVEY.md C15/C16), re-built as importable, testable functions:

- :func:`hin_to_kg` — the HIN → knowledge-graph triple export
  (data/DBLP_four_area/hin2kg.py:17-89): entities are type-prefixed ids
  (``A…/P…/T…/C…``), relations are ``PA/PC/PT``, triples are
  ``(P<pid>, <X><xid>, rel)`` tuples read from the ``paper_*.txt`` link
  tables. Optionally writes the FB15K-style ``entity2id.txt`` /
  ``relation2id.txt`` / ``train.txt`` files plus the
  ``DBLP_Triplets.pickle`` blob the reference pickles (the shipped copy is
  one of the repo's missing large blobs).
- :func:`clean_terms` — the stopword cleanup
  (data/DBLP_four_area/modify_term.py:26-49). The reference script builds
  the NLTK stopword list but never applies it (the filter is commented
  out, so ``term_modify.txt`` equals ``term.txt``); here the filter is
  actually applied — stopword terms are dropped from ``term_modify.txt``
  and their rows from ``paper_term_modify.txt`` — since replicating the
  no-op would make the output pointless (SURVEY.md §7 defect policy).

Both write only under an explicit ``out_dir`` (the reference mutates its
own data directory in place; ours is read-only).
"""

from __future__ import annotations

import pickle
from pathlib import Path

from han_jax.datasets.base import REFERENCE_DATA

RELATIONS = ("PA", "PC", "PT")
_LINK_FILES = {"PA": "paper_author.txt", "PC": "paper_conf.txt", "PT": "paper_term.txt"}
_TARGET_PREFIX = {"PA": "A", "PC": "C", "PT": "T"}


def _read_tsv(path: Path):
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                yield parts[0], parts[1]


def hin_to_kg(root=None, out_dir=None) -> tuple[list, list, list]:
    """Export the DBLP HIN as (ent_list, rel_list, trip_list).

    Entity order matches the reference (authors, papers, terms, confs —
    hin2kg.py:46-50); triples are ``(head, tail, relation)`` string tuples
    in PA, PC, PT order (hin2kg.py:60-86). When ``out_dir`` is given,
    writes ``DBLP_Triplets.pickle`` and FB15K-style id/train files.
    """
    root = Path(root) if root is not None else REFERENCE_DATA / "DBLP_four_area"

    ent_list: list[str] = []
    for prefix, fname in (("A", "author.txt"), ("P", "paper.txt"),
                          ("T", "term.txt"), ("C", "conf.txt")):
        ent_list.extend(prefix + eid for eid, _ in _read_tsv(root / fname))

    trip_list: list[tuple[str, str, str]] = []
    for rel in RELATIONS:
        tgt = _TARGET_PREFIX[rel]
        trip_list.extend(("P" + pid, tgt + xid, rel)
                         for pid, xid in _read_tsv(root / _LINK_FILES[rel]))

    rel_list = list(RELATIONS)
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "DBLP_Triplets.pickle", "wb") as f:
            pickle.dump([ent_list, rel_list, trip_list], f)
        with open(out / "entity2id.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{e}\t{i}\n" for i, e in enumerate(ent_list))
        with open(out / "relation2id.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{r}\t{i}\n" for i, r in enumerate(rel_list))
        with open(out / "train.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{h}\t{t}\t{r}\n" for h, t, r in trip_list)
    return ent_list, rel_list, trip_list


def clean_terms(root=None, out_dir=None, *, stopwords=None) -> dict[str, int]:
    """Drop stopword terms from ``term.txt`` / ``paper_term.txt``.

    Returns counts {'terms_kept', 'terms_dropped', 'links_kept',
    'links_dropped'}; writes ``term_modify.txt`` and
    ``paper_term_modify.txt`` under ``out_dir`` when given. sklearn's
    English stopword list stands in for NLTK's (whose corpus needs a
    network download unavailable here).
    """
    root = Path(root) if root is not None else REFERENCE_DATA / "DBLP_four_area"
    if stopwords is None:
        from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS

        stopwords = ENGLISH_STOP_WORDS
    stop = frozenset(stopwords)

    kept: dict[str, str] = {}
    dropped = 0
    for tid, word in _read_tsv(root / "term.txt"):
        if word.lower() in stop:
            dropped += 1
        else:
            kept[tid] = word

    links_kept, links_dropped = [], 0
    for pid, tid in _read_tsv(root / "paper_term.txt"):
        if tid in kept:
            links_kept.append((pid, tid))
        else:
            links_dropped += 1

    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "term_modify.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{tid}\t{word}\n" for tid, word in kept.items())
        with open(out / "paper_term_modify.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{pid}\t{tid}\n" for pid, tid in links_kept)

    return {"terms_kept": len(kept), "terms_dropped": dropped,
            "links_kept": len(links_kept), "links_dropped": links_dropped}
