"""Stack P per-meta-path graph containers into ONE container with a
leading P axis on every data leaf — the input format for meta-path
(expert-parallel) execution of HAN's towers (SURVEY.md §2.3 EP row:
the P towers are independent until semantic fusion, reference
models/gat.py:39-58, so they vmap/shard over a 'mp' mesh axis).

Containers of one graph family share static metadata after padding:
per-graph true counts that must survive live in DATA arrays (ELL degrees,
sentinel-padded edge lists), so padding never changes results.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from han_jax.graph.containers import CSRGraph, DenseGraph, EllGraph


def _stack(leaves):
    return jnp.stack([jnp.asarray(l) for l in leaves])


def _pad_axis(a, width, axis, fill):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, width - a.shape[axis])
    return jnp.pad(a, pad, constant_values=fill)


def stack_graphs(graphs: Sequence):
    """[container, ...] (same type, same node set) → one container whose
    data leaves carry a leading P axis; static metadata unified."""
    kinds = {type(g) for g in graphs}
    if len(kinds) != 1:
        raise TypeError(f"cannot stack mixed container types {kinds}")
    g0 = graphs[0]
    if any(g.n_nodes != g0.n_nodes for g in graphs):
        raise ValueError("stacked meta-path graphs must share the node set")

    if isinstance(g0, DenseGraph):
        return DenseGraph(adj=_stack([g.adj for g in graphs]),
                          n_nodes=g0.n_nodes)

    if isinstance(g0, CSRGraph):
        # pad edge arrays to a common length; pads keep the sentinel row
        # n_nodes, which every consumer drops, so the unified static
        # n_edges (= max) over-counting is harmless
        e_pad = max(g.e_pad for g in graphs)
        n = g0.n_nodes
        return CSRGraph(
            row_ptr=_stack([g.row_ptr for g in graphs]),
            col_idx=_stack([_pad_axis(g.col_idx, e_pad, 0, n) for g in graphs]),
            row_idx=_stack([_pad_axis(g.row_idx, e_pad, 0, n) for g in graphs]),
            n_nodes=n, n_edges=max(g.n_edges for g in graphs),
        )

    if isinstance(g0, EllGraph):
        f = max(g.fanout for g in graphs)
        n = g0.n_nodes
        return EllGraph(
            nbr=_stack([_pad_axis(g.nbr, f, 1, n) for g in graphs]),
            deg=_stack([g.deg for g in graphs]),
            n_nodes=n, n_edges=max(g.n_edges for g in graphs),
        )

    raise TypeError(f"unsupported container {type(g0)}")
