"""Edge partitioning of CSR graphs across the mesh 'graph' axis.

Partition scheme (SURVEY.md §2.3 "graph/edge partitioning"): destination
nodes are split into S contiguous equal row blocks (N padded up to a
multiple of S); every shard owns its rows' incoming edges. Column (source)
indices stay global: the v1 execution replicates source features along the
graph axis (an all-gather at shard_map entry); the halo-exchange/ring
variant rides the same container.

Per-shard edge arrays are padded to one common static length (max over
shards, rounded up) so the stacked (S, E_loc) arrays are rectangular and
jit-stable. Degree skew (SURVEY.md §7: DBLP conference hubs) is handled by
edge-balanced *row block boundaries*: contiguous row ranges chosen so each
shard's edge count is near-equal, then row blocks padded to the max block
size.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from han_jax.graph.containers import CSRGraph
from han_jax.parallel.mesh import GRAPH_AXIS, HEAD_AXIS


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """CSR row-partitioned into S shards with static shapes.

    row_ptr:  int32[S, n_loc + 1]  — per-shard local CSR row pointers
    col_idx:  int32[S, e_loc]      — GLOBAL source ids, pad = n_nodes
    row_idx:  int32[S, e_loc]      — LOCAL destination rows, pad = n_loc
    row_start:int32[S]             — global id of each shard's first row
    """

    row_ptr: jax.Array
    col_idx: jax.Array
    row_idx: jax.Array
    row_start: jax.Array
    perm: jax.Array    # int32[n_nodes]: padded position of each global row
    n_nodes: int       # true global node count (un-padded)
    n_nodes_pad: int   # S * n_loc
    n_edges: int
    n_shards: int

    @property
    def n_loc(self) -> int:
        return int(self.row_ptr.shape[1]) - 1

    @property
    def e_loc(self) -> int:
        return int(self.col_idx.shape[1])


jax.tree_util.register_pytree_node(
    PartitionedCSR,
    lambda g: ((g.row_ptr, g.col_idx, g.row_idx, g.row_start, g.perm),
               (g.n_nodes, g.n_nodes_pad, g.n_edges, g.n_shards)),
    lambda meta, data: PartitionedCSR(*data, *meta),
)


def partition_csr(
    csr: CSRGraph,
    n_shards: int,
    *,
    balance_edges: bool = True,
    edge_pad_to: int = 128,
) -> PartitionedCSR:
    """Host-side partitioner: CSRGraph → PartitionedCSR with S row blocks."""
    n = csr.n_nodes
    row_ptr = np.asarray(jax.device_get(csr.row_ptr)).astype(np.int64)
    col = np.asarray(jax.device_get(csr.col_idx))[: csr.n_edges].astype(np.int32)
    nnz = csr.n_edges

    # choose contiguous row-block boundaries
    if balance_edges and nnz > 0:
        targets = (np.arange(1, n_shards) * nnz) / n_shards
        bounds = np.searchsorted(row_ptr, targets, side="left")
        bounds = np.clip(bounds, 0, n)
        starts = np.concatenate([[0], bounds, [n]])
        # enforce monotone boundaries
        starts = np.maximum.accumulate(starts)
    else:
        per = -(-n // n_shards)
        starts = np.minimum(np.arange(n_shards + 1) * per, n)

    n_loc = int(max(starts[1:] - starts[:-1]))
    n_loc = max(n_loc, 1)
    e_counts = row_ptr[starts[1:]] - row_ptr[starts[:-1]]
    e_loc = int(e_counts.max()) if nnz else edge_pad_to
    e_loc = max(((e_loc + edge_pad_to - 1) // edge_pad_to) * edge_pad_to, edge_pad_to)

    rp = np.zeros((n_shards, n_loc + 1), dtype=np.int32)
    ci = np.full((n_shards, e_loc), n, dtype=np.int32)
    ri = np.full((n_shards, e_loc), n_loc, dtype=np.int32)
    row_start = starts[:-1].astype(np.int32)
    perm = np.zeros(n, dtype=np.int32)
    for s in range(n_shards):
        r0, r1 = int(starts[s]), int(starts[s + 1])
        perm[r0:r1] = s * n_loc + np.arange(r1 - r0, dtype=np.int32)

    for s in range(n_shards):
        r0, r1 = int(starts[s]), int(starts[s + 1])
        e0, e1 = int(row_ptr[r0]), int(row_ptr[r1])
        cnt = e1 - e0
        ci[s, :cnt] = col[e0:e1]
        local_deg = (row_ptr[r0 : r1 + 1] - row_ptr[r0]).astype(np.int32)
        ri[s, :cnt] = np.repeat(
            np.arange(r1 - r0, dtype=np.int32), np.diff(row_ptr[r0 : r1 + 1]).astype(np.int64))
        rp[s, : r1 - r0 + 1] = local_deg
        rp[s, r1 - r0 + 1 :] = local_deg[-1]

    return PartitionedCSR(
        row_ptr=jnp.asarray(rp),
        col_idx=jnp.asarray(ci),
        row_idx=jnp.asarray(ri),
        row_start=jnp.asarray(row_start),
        perm=jnp.asarray(perm),
        n_nodes=n,
        n_nodes_pad=n_shards * n_loc,
        n_edges=nnz,
        n_shards=n_shards,
    )
