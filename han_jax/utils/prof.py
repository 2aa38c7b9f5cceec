"""Tracing / profiling / numerics-debug utilities (SURVEY.md §5.1-5.2).

The reference has no observability beyond prints; here:

- ``trace(dir)`` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of every XLA launch;
- ``annotate(name)`` — named-scope annotation so kernels group readably in
  the trace viewer;
- ``edges_per_sec`` — the BASELINE.json throughput counter
  (nnz × heads / step_time);
- ``checked(fn)`` — checkify wrapper surfacing NaN/Inf and OOB indexing
  from inside jit as Python errors (CI numerics canary);
- ``device_memory_stats`` — per-device HBM usage snapshot.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; view with TensorBoard's profile plugin."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope for trace readability: ``with annotate('sddmm'): ...``"""
    return jax.named_scope(name)


def edges_per_sec(n_edges: int, n_heads: int, step_time_s: float,
                  n_chips: int = 1) -> float:
    """edges/s/chip for an attention aggregate step (BASELINE.json metric)."""
    return n_edges * n_heads / max(step_time_s, 1e-12) / n_chips


def checked(fn: Callable, *, errors=None) -> Callable:
    """Wrap a jittable fn with checkify NaN/div/OOB checks; the wrapper
    raises on the host when a check fires."""
    from jax.experimental import checkify

    err_set = errors or (checkify.float_checks | checkify.index_checks)
    cfn = checkify.checkify(fn, errors=err_set)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper


def device_memory_stats() -> list[dict]:
    """Memory snapshot of this process's devices (bytes in use / limit when
    available)."""
    out = []
    for d in jax.local_devices():
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except (AttributeError, NotImplementedError):
            pass
        out.append({
            "device": str(d),
            "bytes_in_use": stats.get("bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        })
    return out


class StepTimer:
    """Wall-clock step timer; ``result_fn`` returns the step's output, which
    is waited on (``block_until_ready``) inside the timed region."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self, result_fn: Callable[[], object] | None = None):
        t0 = time.perf_counter()
        yield
        if result_fn is not None:
            jax.block_until_ready(result_fn())
        self.times.append(time.perf_counter() - t0)

    @property
    def median(self) -> float:
        s = sorted(self.times)
        return s[len(s) // 2] if s else float("nan")
