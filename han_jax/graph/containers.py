"""Static-shape graph containers.

Three interchangeable representations of one (homogeneous, possibly
meta-path-induced) graph, all with **fixed shapes** so everything compiles
once under jit:

- :class:`DenseGraph` — boolean N×N adjacency (plus the additive ``-1e9``
  attention bias derived from it). The small-graph oracle path; mirrors the
  reference's dense masked attention (reference ``utils/process.py:14-25``
  ``adj_to_bias`` and ``utils/layers.py:26-27``).
- :class:`CSRGraph` — row_ptr/col_idx with the edge array padded to a fixed
  length; padding edges point at the sentinel row ``n_nodes``. The canonical
  sparse form; feeds the SDDMM / segment-softmax / SpMM path.
- :class:`EllGraph` — ELLPACK: per-row neighbor lists padded to a fixed
  fanout ``(N, F)`` with a validity mask. The gather-based XLA path and the
  neighbor-sampled form for graphs larger than HBM.

All containers are registered pytrees whose static metadata (node/edge
counts) lives in the treedef, so they can be passed through ``jit`` /
``shard_map`` boundaries directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

MASK_VALUE = -1e9  # additive mask for non-edges (reference utils/process.py:25)


def _register_pytree(cls, data_fields: tuple[str, ...], meta_fields: tuple[str, ...]):
    def flatten(obj):
        return (
            tuple(getattr(obj, f) for f in data_fields),
            tuple(getattr(obj, f) for f in meta_fields),
        )

    def unflatten(meta, data):
        kwargs = dict(zip(data_fields, data))
        kwargs.update(dict(zip(meta_fields, meta)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense boolean adjacency with self-loops made explicit.

    ``adj[i, j] = True`` iff node *i* attends to node *j* (j is an in-scope
    neighbor of i). The reference builds this as the nhood-hop reachability
    closure including self-loops (``adj_to_bias``, utils/process.py:14-25).
    """

    adj: jax.Array  # bool[N, N]
    n_nodes: int

    @property
    def bias(self) -> jax.Array:
        """Additive attention bias: 0 on edges, -1e9 off-edge."""
        return jnp.where(self.adj, 0.0, MASK_VALUE).astype(jnp.float32)

    @property
    def n_edges(self) -> int:
        raise TypeError("DenseGraph edge count is data-dependent; use adj.sum()")


_register_pytree(DenseGraph, ("adj",), ("n_nodes",))


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Padded CSR. Rows are destination nodes; columns are source neighbors.

    ``col_idx`` has fixed length ``e_pad`` ≥ nnz; entries past ``n_edges``
    are padding and hold the sentinel value ``n_nodes``. ``row_ptr`` has
    length N+1 and indexes only the real edges (row_ptr[N] == n_edges).
    """

    row_ptr: jax.Array  # int32[N + 1]
    col_idx: jax.Array  # int32[e_pad], pad = n_nodes
    row_idx: jax.Array  # int32[e_pad] expanded row ids (COO form), pad = n_nodes
    n_nodes: int
    n_edges: int  # true nnz (static)

    @property
    def e_pad(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def edge_mask(self) -> jax.Array:
        """bool[e_pad]: True on real edges."""
        return jnp.arange(self.e_pad, dtype=jnp.int32) < self.n_edges


_register_pytree(CSRGraph, ("row_ptr", "col_idx", "row_idx"), ("n_nodes", "n_edges"))


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """ELLPACK: fixed-fanout padded neighbor lists.

    ``nbr[i, f]`` is the f-th in-neighbor of node i, or the sentinel
    ``n_nodes`` when ``f >= degree(i)``. Gather targets should therefore be
    padded with one extra zero row at index ``n_nodes``.
    """

    nbr: jax.Array  # int32[N, F], pad = n_nodes
    deg: jax.Array  # int32[N] true degree (may exceed F if truncated/sampled)
    n_nodes: int
    n_edges: int

    @property
    def fanout(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def nbr_mask(self) -> jax.Array:
        """bool[N, F]: True where a real neighbor is stored."""
        return self.nbr < jnp.int32(self.n_nodes)


_register_pytree(EllGraph, ("nbr", "deg"), ("n_nodes", "n_edges"))


@dataclasses.dataclass(frozen=True)
class TreeEllGraph(EllGraph):
    """ELL block whose rows form a TREE: every non-root row is referenced
    by EXACTLY ONE (row, slot) of ``nbr`` — the no-dedup L-hop layout the
    device-side sampler emits (train/sampled._device_sample_block: level
    l+1 row ``base + r·F + f`` is the f-th sampled in-neighbor of level-l
    row r, and of nothing else).

    ``parent_row[j] / parent_slot[j]`` invert that reference (sentinel
    n_nodes when j is a root/pad row). The attention backward over such a
    block needs NO scatter: the d_logit_src / d_values transposes become
    single gathers through the parent maps (ops/tree_ell.py).
    """

    parent_row: jax.Array = None   # int32[N], sentinel = n_nodes
    parent_slot: jax.Array = None  # int32[N], sentinel = 0


_register_pytree(TreeEllGraph, ("nbr", "deg", "parent_row", "parent_slot"),
                 ("n_nodes", "n_edges"))


# ---------------------------------------------------------------------------
# Builders (host-side, numpy)
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dense_from_numpy(adj: np.ndarray, *, add_self_loops: bool = True, nhood: int = 1) -> DenseGraph:
    """Build a DenseGraph from a (weighted or boolean) numpy adjacency.

    Reproduces the reference reachability-closure semantics of
    ``adj_to_bias(adj, sizes, nhood)`` (utils/process.py:14-25): mask[i, j]
    is True iff j is reachable from i in ≤ nhood hops of (A + I).
    """
    a = np.asarray(adj)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"adjacency must be square 2-D, got {a.shape}")
    n = a.shape[0]
    reach = (a != 0)
    if add_self_loops:
        reach = reach | np.eye(n, dtype=bool)
    if nhood > 1:
        # boolean closure: reach^nhood (reference multiplies (A+I) nhood times)
        step = reach.copy()
        for _ in range(nhood - 1):
            reach = (reach.astype(np.float32) @ step.astype(np.float32)) > 0
    return DenseGraph(adj=jnp.asarray(reach), n_nodes=n)


def csr_from_dense(graph: DenseGraph | np.ndarray, *, edge_pad_to: int = 128) -> CSRGraph:
    """Convert a dense adjacency (host) into padded CSR."""
    if isinstance(graph, DenseGraph):
        a = np.asarray(jax.device_get(graph.adj))
    else:
        a = np.asarray(graph) != 0
    n = a.shape[0]
    rows, cols = np.nonzero(a)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    nnz = rows.shape[0]
    e_pad = max(_round_up(max(nnz, 1), edge_pad_to), edge_pad_to)
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(row_ptr[1:], rows, 1)
    row_ptr = np.cumsum(row_ptr, dtype=np.int64).astype(np.int32)
    col_idx = np.full(e_pad, n, dtype=np.int32)
    row_idx = np.full(e_pad, n, dtype=np.int32)
    col_idx[:nnz] = cols
    row_idx[:nnz] = rows
    return CSRGraph(
        row_ptr=jnp.asarray(row_ptr),
        col_idx=jnp.asarray(col_idx),
        row_idx=jnp.asarray(row_idx),
        n_nodes=n,
        n_edges=int(nnz),
    )


def csr_from_scipy(sp_mat: Any, *, edge_pad_to: int = 128) -> CSRGraph:
    """Build padded CSR from any scipy.sparse matrix."""
    m = sp_mat.tocsr().astype(bool)
    m.sum_duplicates()
    n = m.shape[0]
    nnz = int(m.nnz)
    e_pad = max(_round_up(max(nnz, 1), edge_pad_to), edge_pad_to)
    col_idx = np.full(e_pad, n, dtype=np.int32)
    row_idx = np.full(e_pad, n, dtype=np.int32)
    col_idx[:nnz] = m.indices.astype(np.int32)
    row_idx[:nnz] = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(m.indptr).astype(np.int64)
    )
    return CSRGraph(
        row_ptr=jnp.asarray(m.indptr.astype(np.int32)),
        col_idx=jnp.asarray(col_idx),
        row_idx=jnp.asarray(row_idx),
        n_nodes=n,
        n_edges=nnz,
    )


def ell_from_csr(csr: CSRGraph, *, fanout: int | None = None, pad_to: int = 8) -> EllGraph:
    """Convert padded CSR (host) to ELLPACK with fanout = max degree (or given)."""
    row_ptr = np.asarray(jax.device_get(csr.row_ptr)).astype(np.int64)
    col_idx = np.asarray(jax.device_get(csr.col_idx))[: csr.n_edges]
    n = csr.n_nodes
    deg = np.diff(row_ptr)
    f = int(deg.max()) if fanout is None else int(fanout)
    f = max(_round_up(max(f, 1), pad_to), pad_to)
    nbr = np.full((n, f), n, dtype=np.int32)
    for i in range(n):
        d = min(int(deg[i]), f)
        nbr[i, :d] = col_idx[row_ptr[i] : row_ptr[i] + d]
    return EllGraph(
        nbr=jnp.asarray(nbr),
        deg=jnp.asarray(deg.astype(np.int32)),
        n_nodes=n,
        n_edges=csr.n_edges,
    )


def dense_from_csr(csr: CSRGraph) -> DenseGraph:
    """Materialize a CSRGraph as a dense boolean adjacency (host-side)."""
    n = csr.n_nodes
    rows = np.asarray(jax.device_get(csr.row_idx))[: csr.n_edges]
    cols = np.asarray(jax.device_get(csr.col_idx))[: csr.n_edges]
    a = np.zeros((n, n), dtype=bool)
    a[rows, cols] = True
    return DenseGraph(adj=jnp.asarray(a), n_nodes=n)
