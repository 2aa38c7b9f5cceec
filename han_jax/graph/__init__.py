from han_jax.graph.containers import (  # noqa: F401
    CSRGraph, DenseGraph, EllGraph, MASK_VALUE,
    csr_from_dense, csr_from_scipy, dense_from_csr, dense_from_numpy, ell_from_csr,
)
from han_jax.graph import build, synthetic  # noqa: F401
