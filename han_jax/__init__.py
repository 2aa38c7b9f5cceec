"""han_jax — a heterogeneous graph attention framework in JAX.

A from-scratch JAX/XLA implementation of the HAN model family
(heterogeneous graph attention networks: GAT-style node-level attention over
meta-path induced neighbor graphs, fused by semantic-level attention):

- compute path: XLA einsums for feature transforms and the edge-domain
  attention pipeline (SDDMM edge logits, segment softmax over
  neighborhoods, SpMM aggregation) as XLA gathers and segment sums;
- scale-out: edge-partitioned execution over a ``jax.sharding.Mesh`` with
  XLA collectives (psum / all_gather / ppermute), data-parallel sampled
  training, and neighbor sampling for graphs larger than a device;
- training: jit-compiled full-graph steps, optax Adam + global L2, early
  stopping, pytree checkpoints with deterministic resume, KNN/KMeans
  embedding evaluation.

Reference capability map: CG-Labs/HAN (WWW 2019 official code) — see
SURVEY.md at the repo root for the component-by-component parity inventory.
"""

__version__ = "0.1.0"

from han_jax.graph.containers import CSRGraph, EllGraph, DenseGraph  # noqa: F401
