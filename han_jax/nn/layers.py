"""Neural layers: multi-head graph attention and semantic attention.

Plain-JAX modules: each is a frozen dataclass of hyperparameters whose
parameters live in a nested dict, with a flax-style contract —

    variables = module.init(rng, *inputs)           # {"params": {...}}
    out = module.apply(variables, *inputs, deterministic=False,
                       rngs={"dropout": key})

The math runs through ``han_jax.ops.attention`` so one layer definition
serves every backend (dense oracle / ELL / CSR segment ops / sharded).

Parity notes (reference = CG-Labs/HAN):

- ``GATConv`` reproduces ``attn_head`` (utils/layers.py:7-46) with K heads
  batched into single einsums: per-head feature transform W_k (no bias,
  glorot-uniform — tf.layers.conv1d default), per-head scalar projections
  f_1/f_2 (with bias), LeakyReLU(0.2) → mask → row-softmax → per-head output
  bias → activation. Input dropout is applied independently per head, exactly
  as the reference's per-head ``tf.nn.dropout`` calls.
- ``ConstAttention`` reproduces ``attn_head_const_1`` (utils/layers.py:49-81):
  attention logits replaced by the 0/1 adjacency (the paper's HAN_nd
  ablation).
- ``SemanticAttention`` reproduces ``SimpleAttLayer`` (utils/layers.py:132-164)
  including the *per-node* softmax over meta-paths (the code's behavior, not
  the paper's node-averaged variant) and normal(0.1) initialization.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from han_jax.graph.containers import DenseGraph
from han_jax.ops.attention import Impl, attention_aggregate, leaky_relu

glorot = jax.nn.initializers.glorot_uniform()
zeros = jax.nn.initializers.zeros
normal01 = jax.nn.initializers.normal(stddev=0.1)


def fold(rng: jax.Array | None, i: int) -> jax.Array | None:
    """Sub-stream ``i`` of a dropout key (None stays None)."""
    return None if rng is None else jax.random.fold_in(rng, i)


def dropout(rng: jax.Array, rate: float, x: jax.Array) -> jax.Array:
    """Inverted dropout: zero with probability ``rate``, rescale the rest."""
    keep = 1.0 - rate
    return jnp.where(jax.random.bernoulli(rng, keep, x.shape), x / keep, 0.0)


class Module:
    """``init``/``apply`` around a subclass's ``init`` and ``__call__``
    (``__call__(params, *inputs, deterministic=..., rng=...)``)."""

    def apply(self, variables: dict, *args, deterministic: bool = True,
              rngs: dict | None = None, **kwargs):
        rng = None if rngs is None else rngs.get("dropout")
        return self(variables["params"], *args, deterministic=deterministic,
                    rng=rng, **kwargs)


def _need_rng(rng, rates) -> None:
    if rng is None and any(r > 0.0 for r in rates):
        raise ValueError("training-mode dropout needs rngs={'dropout': key}")


def dense_params(rng: jax.Array, in_dim: int, out_dim: int) -> dict:
    """A bias-carrying linear layer (flax ``nn.Dense`` names and inits)."""
    return {"kernel": glorot(rng, (in_dim, out_dim), jnp.float32),
            "bias": zeros(rng, (out_dim,), jnp.float32)}


@dataclasses.dataclass(frozen=True)
class GATConv(Module):
    """Multi-head graph attention convolution (reference attn_head × K heads).

    Output is the concatenation over heads: (N, K * out_dim) when
    ``concat_heads`` else the head-mean (N, out_dim).
    """

    out_dim: int
    num_heads: int
    activation: Callable[[jax.Array], jax.Array] = jax.nn.elu
    slope: float = 0.2
    attn_drop: float = 0.0
    ffd_drop: float = 0.0
    residual: bool = False
    concat_heads: bool = True
    impl: Impl = "auto"
    # compute dtype for features and transforms (params stay f32, all
    # matmuls accumulate f32 via preferred_element_type; attention logits
    # are promoted to f32 before the softmax)
    dtype: Any = jnp.float32

    def init(self, rng, graph, x):
        return {"params": self.init_params(rng, x.shape[-1])}

    def init_params(self, rng: jax.Array, in_dim: int) -> dict:
        k, d = self.num_heads, self.out_dim
        r = jax.random.split(rng, 4)
        f32 = jnp.float32
        params = {
            "kernel": glorot(r[0], (in_dim, k, d), f32),
            "attn_dst_kernel": glorot(r[1], (k, d), f32),
            "attn_dst_bias": zeros(r[1], (k,), f32),
            "attn_src_kernel": glorot(r[2], (k, d), f32),
            "attn_src_bias": zeros(r[2], (k,), f32),
            "bias": zeros(r[3], (k, d), f32),
        }
        if self.residual and in_dim != d:
            params["res_kernel"] = glorot(r[3], (in_dim, k, d), f32)
        return params

    def __call__(self, params, graph, x: jax.Array, *,
                 deterministic: bool = True, rng: jax.Array | None = None,
                 return_coefs: bool = False):
        n, f = x.shape
        k, d = self.num_heads, self.out_dim
        x = x.astype(self.dtype)
        w = params["kernel"].astype(self.dtype)

        drop_in = self.ffd_drop if not deterministic else 0.0
        drop_coef = self.attn_drop if not deterministic else 0.0
        _need_rng(rng, (drop_in, drop_coef))

        if drop_in > 0.0:
            # independent input dropout per head (reference drops `seq` inside
            # each attn_head call, layers.py:18-19)
            xk = dropout(fold(rng, 0), drop_in, jnp.broadcast_to(x[None], (k, n, f)))
            fts = jnp.einsum("knf,fkd->nkd", xk, w,
                             preferred_element_type=jnp.float32).astype(x.dtype)
        else:
            fts = jnp.einsum("nf,fkd->nkd", x, w,
                             preferred_element_type=jnp.float32).astype(x.dtype)

        # per-head scalar attention terms (reference f_1 / f_2, layers.py:
        # 23-24), f32 regardless of compute dtype: exp() wants the mantissa
        logit_dst = (jnp.einsum("nkd,kd->nk", fts, params["attn_dst_kernel"],
                                preferred_element_type=jnp.float32)
                     + params["attn_dst_bias"]).astype(jnp.float32)
        logit_src = (jnp.einsum("nkd,kd->nk", fts, params["attn_src_kernel"],
                                preferred_element_type=jnp.float32)
                     + params["attn_src_bias"]).astype(jnp.float32)

        # feature dropout before aggregation (reference layers.py:31-32)
        fts_agg = dropout(fold(rng, 1), drop_in, fts) if drop_in > 0.0 else fts

        agg = attention_aggregate(
            graph, fts_agg, logit_dst, logit_src,
            slope=self.slope, coef_dropout=drop_coef,
            dropout_rng=fold(rng, 2) if drop_coef > 0.0 else None,
            impl=self.impl, return_coefs=return_coefs,
        )
        if return_coefs:
            agg, coefs = agg

        ret = agg.astype(jnp.float32) + params["bias"][None]  # (N, K, D), f32

        if self.residual:
            if f != d:
                ret = ret + jnp.einsum("nf,fkd->nkd", x, params["res_kernel"],
                                       preferred_element_type=jnp.float32)
            else:
                ret = ret + x[:, None, :].astype(jnp.float32)

        out = self.activation(ret)
        out = out.reshape(n, k * d) if self.concat_heads else out.mean(axis=1)
        if return_coefs:
            return out, coefs
        return out


@dataclasses.dataclass(frozen=True)
class ConstAttention(Module):
    """Uniform-over-neighbors ablation head (reference attn_head_const_1,
    utils/layers.py:49-81): logits = adjacency (1 on edges, 0 off) rather than
    learned, then the same masked softmax / aggregation path."""

    out_dim: int
    num_heads: int
    activation: Callable[[jax.Array], jax.Array] = jax.nn.elu
    slope: float = 0.2
    attn_drop: float = 0.0
    ffd_drop: float = 0.0
    concat_heads: bool = True

    def init(self, rng, graph, x):
        k, d = self.num_heads, self.out_dim
        return {"params": {
            "kernel": glorot(rng, (x.shape[-1], k, d), jnp.float32),
            "bias": zeros(rng, (k, d), jnp.float32)}}

    def __call__(self, params, graph: DenseGraph, x: jax.Array, *,
                 deterministic: bool = True, rng: jax.Array | None = None):
        if not isinstance(graph, DenseGraph):
            raise TypeError("ConstAttention requires a DenseGraph")
        n = x.shape[0]
        k, d = self.num_heads, self.out_dim
        drop_in = self.ffd_drop if not deterministic else 0.0
        drop_coef = self.attn_drop if not deterministic else 0.0
        _need_rng(rng, (drop_in, drop_coef))

        xs = dropout(fold(rng, 0), drop_in, x) if drop_in > 0.0 else x
        fts = jnp.einsum("nf,fkd->nkd", xs, params["kernel"],
                         preferred_element_type=jnp.float32).astype(x.dtype)

        adj01 = graph.adj.astype(jnp.float32)  # reference: 1 - bias/-1e9
        logits = leaky_relu(adj01, self.slope)
        coefs = jax.nn.softmax(logits + graph.bias, axis=-1)  # (N, N)
        if drop_coef > 0.0:
            coefs = dropout(fold(rng, 1), drop_coef, coefs)
        if drop_in > 0.0:
            fts = dropout(fold(rng, 2), drop_in, fts)
        agg = jnp.einsum("nm,mkd->nkd", coefs, fts,
                         preferred_element_type=jnp.float32).astype(x.dtype)
        out = self.activation(agg + params["bias"][None])
        return out.reshape(n, k * d) if self.concat_heads else out.mean(axis=1)


@dataclasses.dataclass(frozen=True)
class SemanticAttention(Module):
    """Fuse P per-meta-path embeddings into one (reference SimpleAttLayer).

    Input (N, P, D) → (output (N, D), alphas (N, P)); alphas are per-node
    (softmax over the meta-path axis, utils/layers.py:155-156).
    """

    attention_dim: int = 128

    def init(self, rng, inputs):
        return {"params": self.init_params(rng, inputs.shape[-1])}

    def init_params(self, rng: jax.Array, in_dim: int) -> dict:
        a = self.attention_dim
        r = jax.random.split(rng, 3)
        return {"w_omega": normal01(r[0], (in_dim, a), jnp.float32),
                "b_omega": normal01(r[1], (a,), jnp.float32),
                "u_omega": normal01(r[2], (a,), jnp.float32)}

    def __call__(self, params, inputs: jax.Array, *, deterministic: bool = True,
                 rng: jax.Array | None = None):
        v = jnp.tanh(jnp.einsum("npd,da->npa", inputs, params["w_omega"])
                     + params["b_omega"])
        vu = jnp.einsum("npa,a->np", v, params["u_omega"])
        alphas = jax.nn.softmax(vu, axis=-1)  # (N, P)
        output = jnp.sum(inputs * alphas[:, :, None], axis=1)  # (N, D)
        return output, alphas
