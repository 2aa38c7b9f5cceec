"""Typed configuration system (replaces the reference's module-level
constants, ex_acm3025.py:16-31) with per-dataset presets reproducing exactly
those hyperparameters."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence


@dataclasses.dataclass
class ModelConfig:
    arch: str = "han"  # han | han_shared | gat
    hid_units: Sequence[int] = (8,)
    n_heads: Sequence[int] = (8, 1)
    semantic_dim: int = 128  # mp_att_size (gat.py:37)
    residual: bool = False
    attn_drop: float = 0.6
    ffd_drop: float = 0.6
    impl: str = "auto"  # dense | ell | csr | auto (follow the container)
    vmap_towers: bool = False  # meta-path EP: one vmapped tower stack
    # compute dtype for features/transforms ('float32' | 'bfloat16');
    # params + softmax logits + accumulators stay f32 (nn/layers.GATConv)
    dtype: str = "float32"


@dataclasses.dataclass
class DataConfig:
    dataset: str = "acm"
    featype: str = "fea"  # 'fea' | 'adj' (ex_acm3025.py:92-93)
    edge_pad_to: int = 128
    # container to feed: dense | csr | ell; with mesh.graph_axis > 1 csr
    # becomes PartitionedCSR and ring the PartitionedCSR2D ring exchange
    graph_format: str = "dense"


@dataclasses.dataclass
class TrainConfig:
    lr: float = 0.005
    l2_coef: float = 0.001
    epochs: int = 200
    patience: int = 100
    seed: int = 42
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 0  # additionally every N epochs (0 = only on best)
    log_file: str = ""  # jsonl metrics log ("" = stdout only)
    # mini-batch neighbor-sampled training (train/sampled.py) instead of
    # full-graph steps — the >HBM path (SURVEY.md §2.3 sampling row):
    #   --set train.sampled=true [--set train.sampler=device]
    sampled: bool = False
    batch_size: int = 512        # seed nodes per sampled step
    fanout: int = 16             # sampled in-neighbors per node per hop
    sampler: str = "host"        # host (C++ sampler) | device (in-step)


@dataclasses.dataclass
class MeshConfig:
    """Device mesh axes: graph (edge/node shards) × heads (head/model
    shards) × mp (meta-path expert parallelism).

    SURVEY.md §2.3/§5.8 — data-parallel PPI batching rides the graph axis.
    """

    graph_axis: int = 1
    head_axis: int = 1
    mp_axis: int = 1


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def preset(name: str) -> Config:
    """Per-dataset presets mirroring the reference constants
    (lr 0.005, L2 1e-3, hid 8, heads [8,1], dropout 0.6, patience 100 —
    ex_acm3025.py:16-31 / han.pdf §5.3)."""
    cfg = Config()
    cfg.data.dataset = name
    if name in ("acm", "acm_synthetic"):
        pass  # defaults are the ACM constants
    elif name == "dblp":
        # APCPA/APTPA are multi-million-edge: O(E) edge-domain segment ops
        # (a dense (K, N, N) tower is 0.5 GB per array at N=4057)
        cfg.data.graph_format = "csr"
    elif name in ("imdb", "imdb_strict"):
        pass
    elif name == "ppi":
        cfg.model.arch = "gat"
        cfg.model.hid_units = (256, 256)
        cfg.model.n_heads = (4, 4, 6)
        cfg.model.residual = True
        cfg.model.attn_drop = 0.0
        cfg.model.ffd_drop = 0.0
        cfg.train.lr = 0.005
        cfg.train.l2_coef = 0.0
    elif name == "powerlaw":
        cfg.data.graph_format = "csr"
        cfg.model.impl = "csr"
    elif name in ("cora", "citeseer", "pubmed"):
        # homogeneous citation graphs → GAT (GAT-paper hyperparams; the
        # reference ships only the loader, utils/process.py:47-98)
        cfg.model.arch = "gat"
        cfg.train.l2_coef = 0.0005
        if name == "pubmed":  # N=19717: dense N^2 is wasteful
            cfg.data.graph_format = "csr"
    else:
        raise KeyError(f"no preset for dataset {name!r}")
    return cfg


def _apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply 'section.key=value' CLI overrides."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        section, _, field = key.partition(".")
        obj = getattr(cfg, section)
        cur = getattr(obj, field)  # raises on unknown field
        if isinstance(cur, bool):
            parsed = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            parsed = int(val)
        elif isinstance(cur, float):
            parsed = float(val)
        elif isinstance(cur, (tuple, list)):
            parsed = tuple(int(v) for v in val.split(",") if v)
        else:
            parsed = val
        setattr(obj, field, parsed)
    return cfg


def parse_cli(argv: Sequence[str] | None = None) -> Config:
    p = argparse.ArgumentParser(description="han_jax trainer")
    p.add_argument("--dataset", default="acm")
    p.add_argument("--set", action="append", default=[], metavar="sec.key=val",
                   help="config override, e.g. --set train.lr=0.01")
    args = p.parse_args(argv)
    cfg = preset(args.dataset)
    return _apply_overrides(cfg, args.set)
