"""Model family: GAT (homogeneous) and HAN (heterogeneous) variants.

Parity map to the reference (CG-Labs/HAN, models/gat.py):

- :class:`GAT`          ↔ ``GAT.inference`` (gat.py:8-32): multi-head concat
  layers, output layer = mean of heads projecting to n_classes via attention.
- :class:`HAN`          ↔ ``HeteGAT_multi.inference`` (gat.py:34-77):
  per-meta-path feature inputs, independent GAT towers per meta-path,
  semantic attention fusion, Dense classifier head(s) averaged.
- :class:`HANShared`    ↔ ``HeteGAT.inference`` (gat.py:132-203): a single
  shared feature input across meta-paths + optional per-meta-path mean
  attention-coefficient output (``return_coefs``).

The reference's ``HeteGAT_no_coef`` (gat.py:79-130) is a broken duplicate of
``HeteGAT`` (NameError at gat.py:93) and is intentionally not replicated —
``HANShared(return_coefs=False)`` is its working equivalent.

Parameter trees keep flax's names (``tower_{p}/GATConv_{i}``,
``SemanticAttention_0``, ``classifier_{i}``; ``towers`` with a leading P
axis under ``vmap_towers``). Random streams are derived by position, not by
module name: tower p draws its init and dropout keys from
``fold_in(key, p)``, so a vmapped tower stack and the sequential towers get
identical parameters and identical dropout masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

from han_jax.nn.layers import GATConv, Module, SemanticAttention, dense_params, fold
from han_jax.ops.attention import Impl


@dataclasses.dataclass(frozen=True)
class GAT(Module):
    """Homogeneous multi-layer GAT; logits head = mean of attention heads
    projecting directly to class space (reference gat.py:24-30)."""

    n_classes: int
    hid_units: Sequence[int] = (8,)
    n_heads: Sequence[int] = (8, 1)
    activation: Callable = jax.nn.elu
    residual: bool = False
    attn_drop: float = 0.0
    ffd_drop: float = 0.0
    impl: Impl = "auto"
    dtype: Any = jnp.float32  # compute dtype (see layers.GATConv)

    def _layers(self) -> list[GATConv]:
        # the hidden layers are a HAN tower's; the output layer averages its
        # heads straight into class space
        return _tower_of(self)._layers() + [GATConv(
            self.n_classes, self.n_heads[-1], activation=lambda v: v,
            attn_drop=self.attn_drop, ffd_drop=self.ffd_drop,
            concat_heads=False, impl=self.impl, dtype=self.dtype)]

    def init(self, rng, graph, x):
        params, in_dim = {}, x.shape[-1]
        for i, layer in enumerate(self._layers()):
            params[f"GATConv_{i}"] = layer.init_params(fold(rng, i), in_dim)
            in_dim = layer.num_heads * layer.out_dim
        return {"params": params}

    def __call__(self, params, graph, x, *, deterministic: bool = True,
                 rng: jax.Array | None = None):
        h = x
        for i, layer in enumerate(self._layers()):
            h = layer(params[f"GATConv_{i}"], graph, h,
                      deterministic=deterministic, rng=fold(rng, i))
        return h  # (N, C)


@dataclasses.dataclass(frozen=True)
class _MetapathTower:
    """One per-meta-path GAT stack: n_heads[0] concat heads at hid_units[0],
    then optional deeper layers (reference gat.py:42-57)."""

    hid_units: Sequence[int]
    n_heads: Sequence[int]
    activation: Callable
    residual: bool
    attn_drop: float
    ffd_drop: float
    impl: Impl
    dtype: Any

    def _layers(self) -> list[GATConv]:
        common = dict(activation=self.activation, attn_drop=self.attn_drop,
                      ffd_drop=self.ffd_drop, impl=self.impl, dtype=self.dtype)
        return [GATConv(self.hid_units[i], self.n_heads[i],
                        residual=self.residual and i > 0, **common)
                for i in range(len(self.hid_units))]

    @property
    def out_dim(self) -> int:
        return self.n_heads[len(self.hid_units) - 1] * self.hid_units[-1]

    def init_params(self, rng, in_dim: int) -> dict:
        params = {}
        for i, layer in enumerate(self._layers()):
            params[f"GATConv_{i}"] = layer.init_params(fold(rng, i), in_dim)
            in_dim = layer.num_heads * layer.out_dim
        return params

    def __call__(self, params, graph, x, *, deterministic: bool = True,
                 rng: jax.Array | None = None, return_coefs: bool = False):
        coefs = None
        h = x
        for i, layer in enumerate(self._layers()):
            out = layer(params[f"GATConv_{i}"], graph, h,
                        deterministic=deterministic, rng=fold(rng, i),
                        return_coefs=return_coefs and i == 0)
            h, coefs = out if (return_coefs and i == 0) else (out, coefs)
        if return_coefs:
            # mean over heads (reference gat.py:172-173): dense coefs are
            # (K, N, N) → (N, N); csr edge coefs are (E_pad, K) → (E_pad,),
            # aligned with the graph's row_idx/col_idx
            coefs = coefs.mean(axis=0) if coefs.ndim == 3 else coefs.mean(axis=-1)
            return h, coefs
        return h


def _tower_of(model) -> _MetapathTower:
    """The per-meta-path tower a HAN / HANShared model runs."""
    return _MetapathTower(model.hid_units, model.n_heads, model.activation,
                          model.residual, model.attn_drop, model.ffd_drop,
                          model.impl, model.dtype)


def _head_params(rng, tower: _MetapathTower, semantic_dim: int,
                 n_classes: int, n_classifiers: int) -> dict:
    """Semantic attention + the averaged Dense classifier heads."""
    k_sem, k_cls = jax.random.split(rng)
    params = {"SemanticAttention_0": SemanticAttention(semantic_dim).init_params(
        k_sem, tower.out_dim)}
    for i in range(n_classifiers):
        params[f"classifier_{i}"] = dense_params(fold(k_cls, i), tower.out_dim,
                                                 n_classes)
    return params


def _fuse_and_classify(params, multi, semantic_dim: int, n_classifiers: int):
    """(N, P, D) tower embeddings → (logits, fused embedding, alphas)."""
    final, alphas = SemanticAttention(semantic_dim)(
        params["SemanticAttention_0"], multi)
    # classifier: mean of n_heads[-1] Dense layers (reference gat.py:66-76
    # — a plain Dense head, NOT an attention head)
    logits = sum(final @ params[f"classifier_{i}"]["kernel"]
                 + params[f"classifier_{i}"]["bias"]
                 for i in range(n_classifiers)) / n_classifiers
    return logits, final, alphas


@dataclasses.dataclass(frozen=True)
class HAN(Module):
    """Heterogeneous graph attention network (reference HeteGAT_multi).

    ``apply(variables, graphs, xs)`` takes P graphs (one per meta-path) and P
    feature arrays (typically the same array repeated); returns
    ``(logits (N, C), embedding (N, K*hid), alphas (N, P))``.

    ``vmap_towers=True`` enables meta-path (expert) parallelism (SURVEY.md
    §2.3 EP row): ``graphs`` must be ONE stacked container
    (graph/stack.stack_graphs) and ``xs`` a (P, N, F) array; the P towers
    run as one ``jax.vmap`` over stacked tower params whose P axis shards
    over the mesh 'mp' axis when one is active — the towers are independent
    until semantic fusion (reference gat.py:39-58), which is where the
    (N, P, K·hid) stack is (implicitly) all-gathered.
    """

    n_classes: int
    hid_units: Sequence[int] = (8,)
    n_heads: Sequence[int] = (8, 1)
    semantic_dim: int = 128
    activation: Callable = jax.nn.elu
    residual: bool = False
    attn_drop: float = 0.0
    ffd_drop: float = 0.0
    impl: Impl = "auto"
    dtype: Any = jnp.float32  # compute dtype (see layers.GATConv)
    vmap_towers: bool = False

    def init(self, rng, graphs, xs):
        tower = _tower_of(self)
        k_towers, k_head = jax.random.split(rng)
        n_paths = xs.shape[0] if self.vmap_towers else len(xs)
        towers = [tower.init_params(fold(k_towers, p), xs[p].shape[-1])
                  for p in range(n_paths)]
        if self.vmap_towers:
            params = {"towers": jax.tree_util.tree_map(
                lambda *ls: jnp.stack(ls), *towers)}
        else:
            params = {f"tower_{p}": t for p, t in enumerate(towers)}
        params.update(_head_params(k_head, tower, self.semantic_dim,
                                   self.n_classes, self.n_heads[-1]))
        return {"params": params}

    def __call__(self, params, graphs, xs, *, deterministic: bool = True,
                 rng: jax.Array | None = None):
        tower = _tower_of(self)
        if self.vmap_towers:
            n_paths = xs.shape[0]
            mesh = jax.sharding.get_abstract_mesh()
            has_mp = (mesh is not None and not mesh.empty
                      and "mp" in mesh.axis_names)
            keys = (None if rng is None else
                    jnp.stack([fold(rng, p) for p in range(n_paths)]))

            def one(p, g, x, key):
                return tower(p, g, x, deterministic=deterministic, rng=key)

            # spmd_axis_name threads the tower axis INTO any shard_map the
            # towers contain (the Partitioned/Ring distributed backends)
            embeds = jax.vmap(
                one, in_axes=(0, 0, 0, None if keys is None else 0),
                spmd_axis_name="mp" if has_mp else None,
            )(params["towers"], graphs, xs, keys)  # (P, N, KH)
            if has_mp:
                # pin the tower axis to the mp mesh axis so GSPMD executes
                # each tower on its own shard (EP), gathering only the
                # (P, N, K·hid) embeddings for the semantic fusion below
                embeds = jax.lax.with_sharding_constraint(
                    embeds, jax.sharding.PartitionSpec("mp"))
            multi = jnp.swapaxes(embeds, 0, 1)  # (N, P, K*hid)
        else:
            embeds = [tower(params[f"tower_{p}"], graph, x,
                            deterministic=deterministic, rng=fold(rng, p))
                      for p, (graph, x) in enumerate(zip(graphs, xs))]
            multi = jnp.stack(embeds, axis=1)  # (N, P, K*hid)
        return _fuse_and_classify(params, multi, self.semantic_dim,
                                  self.n_heads[-1])


@dataclasses.dataclass(frozen=True)
class HANShared(Module):
    """HAN with one shared feature input across meta-paths and optional mean
    attention-coefficient output per meta-path (reference HeteGAT,
    gat.py:132-203). Coefficients come from the dense backend as (N, N)
    matrices or from the csr backend as per-edge vectors aligned with each
    graph's row_idx/col_idx — attention analysis works at any scale the
    edge-domain backend reaches."""

    n_classes: int
    hid_units: Sequence[int] = (8,)
    n_heads: Sequence[int] = (8, 1)
    semantic_dim: int = 128
    activation: Callable = jax.nn.elu
    residual: bool = False
    attn_drop: float = 0.0
    ffd_drop: float = 0.0
    impl: Impl = "auto"
    dtype: Any = jnp.float32  # compute dtype (see layers.GATConv)
    return_coefs: bool = False

    def init(self, rng, graphs: Sequence, x: jax.Array):
        tower = _tower_of(self)
        k_towers, k_head = jax.random.split(rng)
        params = {f"tower_{p}": tower.init_params(fold(k_towers, p), x.shape[-1])
                  for p in range(len(graphs))}
        params.update(_head_params(k_head, tower, self.semantic_dim,
                                   self.n_classes, self.n_heads[-1]))
        return {"params": params}

    def __call__(self, params, graphs: Sequence, x: jax.Array, *,
                 deterministic: bool = True, rng: jax.Array | None = None):
        tower = _tower_of(self)
        embeds, coef_list = [], []
        for p, graph in enumerate(graphs):
            out = tower(params[f"tower_{p}"], graph, x,
                        deterministic=deterministic, rng=fold(rng, p),
                        return_coefs=self.return_coefs)
            if self.return_coefs:
                h, coefs = out
                coef_list.append(coefs)
            else:
                h = out
            embeds.append(h)
        multi = jnp.stack(embeds, axis=1)
        logits, final, alphas = _fuse_and_classify(
            params, multi, self.semantic_dim, self.n_heads[-1])
        if self.return_coefs:
            return logits, final, alphas, coef_list
        return logits, final, alphas
