"""Test configuration (platform forcing lives in the ROOT conftest.py,
which must run before any jax backend initializes — SURVEY.md §4.5:
distributed code paths are exercised with 8 virtual CPU devices, so the
suite needs no accelerator)."""

import jax

from han_jax.utils.cache import setup_compile_cache

jax.config.update("jax_enable_x64", False)
# Persistent compilation cache (its own directory: CPU programs only), so
# re-runs skip the first compile of every program.
setup_compile_cache(".jax_cache_cpu")
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from han_jax.graph import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def tiny_ds():
    """Small planted heterogeneous dataset shared across tests."""
    return synthetic.planted_hetero(
        n_nodes=96, n_feats=24, n_classes=3, n_metapaths=2,
        avg_degree=6.0, train_per_class=10, n_val=16, seed=7, name="tiny",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
