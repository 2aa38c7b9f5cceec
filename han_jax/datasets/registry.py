"""Dataset registry: name → loader."""

from __future__ import annotations

from typing import Callable

from han_jax.datasets.base import HeteroDataset

_REGISTRY: dict[str, Callable[..., HeteroDataset]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def load_dataset(name: str, **kwargs) -> HeteroDataset | "MultiGraphDataset":
    if name in ("acm", "acm3025"):
        from han_jax.datasets.acm import load_acm3025
        return load_acm3025(**kwargs)
    if name == "acm_synthetic":
        from han_jax.datasets.acm import acm_synthetic
        return acm_synthetic(**kwargs)
    if name == "dblp":
        from han_jax.datasets.dblp import load_dblp
        return load_dblp(**kwargs)
    if name == "imdb":
        # subset="all" measured better micro-F1 at every split than the
        # "strict" filter; strict kept as alias
        from han_jax.datasets.imdb import load_imdb
        kwargs.setdefault("subset", "all")
        return load_imdb(**kwargs)
    if name == "imdb_strict":
        from han_jax.datasets.imdb import load_imdb
        return load_imdb(subset="strict", **kwargs)
    if name == "powerlaw":
        from han_jax.graph.synthetic import powerlaw_hetero
        return powerlaw_hetero(**kwargs)
    if name == "ppi":
        # inductive multi-graph dataset (returns MultiGraphDataset, not
        # HeteroDataset — train.run() routes it to the InductiveTrainer);
        # real GraphSAGE-format files when present (the reference checkout
        # ships none — utils/process_ppi.py:85), synthetic fixture otherwise
        import pathlib

        from han_jax.datasets.ppi import load_ppi, ppi_synthetic
        root = pathlib.Path(kwargs.pop("root", "data_cache/ppi"))
        if (root / "ppi-G.json").exists():
            return load_ppi(root, **kwargs)
        return ppi_synthetic(**kwargs)
    if name in ("cora", "citeseer", "pubmed"):
        from han_jax.datasets.planetoid import load_planetoid
        kwargs.setdefault("root", "data_cache/planetoid")
        return load_planetoid(name=name, **kwargs)
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    raise KeyError(f"unknown dataset {name!r}; known: acm, acm_synthetic, dblp, "
                   f"imdb, ppi, powerlaw, cora, citeseer, pubmed, {sorted(_REGISTRY)}")
