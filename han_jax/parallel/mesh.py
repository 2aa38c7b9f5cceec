"""Device mesh construction: ('graph', 'heads') axes.

- ``graph``: edge/node partition of each meta-path adjacency (the GNN analog
  of sequence/context parallelism — SURVEY.md §2.3, §5.7) and the data axis
  for multi-graph (PPI) batching.
- ``heads``: attention heads sharded model-parallel (heads are independent
  until the concat, reference gat.py:42-46).

The mesh is a plain reshape of the device list; XLA lowers the
collectives (SURVEY.md §5.8).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

GRAPH_AXIS = "graph"
HEAD_AXIS = "heads"
MP_AXIS = "mp"  # meta-path (expert-parallel) axis — SURVEY.md §2.3 EP row


def make_mesh(graph: int = 0, heads: int = 1, mp: int = 1, devices=None) -> Mesh:
    """Build a (graph × heads) — or (mp × graph × heads) when mp > 1 —
    mesh. graph=0 → use all remaining devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if graph == 0:
        if n % (heads * mp):
            raise ValueError(f"{n} devices not divisible by heads*mp={heads * mp}")
        graph = n // (heads * mp)
    if mp * graph * heads > n:
        raise ValueError(f"mesh {mp}x{graph}x{heads} exceeds {n} devices")
    if mp > 1:
        devs = devices[: mp * graph * heads].reshape(mp, graph, heads)
        return Mesh(devs, (MP_AXIS, GRAPH_AXIS, HEAD_AXIS))
    devs = devices[: graph * heads].reshape(graph, heads)
    return Mesh(devs, (GRAPH_AXIS, HEAD_AXIS))
