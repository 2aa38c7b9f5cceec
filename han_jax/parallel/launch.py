"""Multi-process / multi-host initialization (SURVEY.md §5.8).

The reference is single-process (SURVEY.md §2.3); scale-out here rides
``jax.distributed`` — every host runs the same program, JAX wires the
hosts into one system, and the mesh in parallel/mesh.py spans all their
devices. XLA lowers the collectives; there is no explicit NCCL/MPI layer.

Typical flow on each host::

    from han_jax.parallel import launch, mesh
    launch.init_distributed()              # no-op when single-process
    m = mesh.make_mesh(graph=0, heads=1)   # all global devices
    ... pjit / shard_map as usual ...

Coordinates resolve from explicit arguments, else the ``HAN_*``
variables below; nothing is auto-detected. Any other ``HAN_*`` variable
naming a coordinate (the names launchers set before the package was
renamed ``han_jax``) is an error, so that an old launcher fails loudly
rather than starting each host as its own single-process job.
"""

from __future__ import annotations

import os

import jax

_INITIALIZED = False
_ENV = ("HAN_COORDINATOR", "HAN_NUM_PROCESSES", "HAN_PROCESS_ID")
_FIELDS = tuple(name[len("HAN"):] for name in _ENV)


def _check_env() -> None:
    stray = sorted(k for k in os.environ if k.startswith("HAN_")
                   and k.endswith(_FIELDS) and k not in _ENV)
    if stray:
        raise RuntimeError(
            f"launcher variables {stray} are not read; set "
            f"{' / '.join(_ENV)} instead")


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Join the multi-process JAX system; safe to call when single-process.

    Resolution order per field: explicit argument → ``HAN_COORDINATOR``
    / ``HAN_NUM_PROCESSES`` / ``HAN_PROCESS_ID`` env vars. Without a
    coordinator address (the single-process case) this is a no-op. Raises
    ``RuntimeError`` when another ``HAN_*`` coordinate variable is set (see
    the module docstring).

    Returns {'process_id', 'num_processes', 'local_devices',
    'global_devices'} for logging.
    """
    global _INITIALIZED
    _check_env()
    coordinator_address = coordinator_address or os.environ.get("HAN_COORDINATOR")
    if num_processes is None and "HAN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["HAN_NUM_PROCESSES"])
    if process_id is None and "HAN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["HAN_PROCESS_ID"])

    if not _INITIALIZED and coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        _INITIALIZED = True

    return {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_coordinator() -> bool:
    """True on the process that should write checkpoints / logs."""
    return jax.process_index() == 0
