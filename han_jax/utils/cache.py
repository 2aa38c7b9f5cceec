"""Where JAX keeps its persistent compilation cache.

One rule for every entry point: when ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and nothing here sets another directory; otherwise the
cache lives at a fixed path inside the checkout (``.jax_cache``, or a
separate name such as ``.jax_cache_cpu`` for the CPU test suite), so a
second run of the same checkout finds what the first one compiled.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(name: str = ".jax_cache", environ=None) -> tuple[str, bool]:
    """(directory, whether code must set it) under the rule above."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV):
        return environ[ENV], False
    return str(CHECKOUT / name), True


def setup_compile_cache(name: str = ".jax_cache") -> str:
    """Apply the rule to this process's JAX config; returns the directory."""
    import jax

    path, must_set = compile_cache_dir(name)
    if must_set:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
