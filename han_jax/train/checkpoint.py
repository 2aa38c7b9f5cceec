"""Pytree checkpoints shared by the three trainers.

One directory per step under the manager's root, each holding one
``state.npz`` whose entries are keyed by the leaves' pytree paths. A save
is written under a temporary name and moved into place with
``os.replace``, so a reader (or a run resumed after a kill) sees either the
whole step or none of it. ``restore`` fills a template pytree of the same
structure, putting every leaf on the template leaf's sharding (a
single-device leaf on the default device, uncommitted).

In a multi-process run every process calls ``save`` and ``restore`` with
the same arguments (the directory must be shared storage): only the
coordinator writes, and a barrier after each save and before each restore
keeps the other processes from reading a step that is not in place yet.
"""

from __future__ import annotations

import os
import pathlib
import shutil

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import SingleDeviceSharding

from han_jax.parallel.launch import is_coordinator

_STATE = "state.npz"


def _barrier(name: str) -> None:
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(name)


def _flat(tree) -> list[tuple[str, object]]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in leaves]


class CheckpointManager:
    """Save / find / restore full-state checkpoints under ``directory``."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _STATE).is_file())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        arrays = {key: np.asarray(jax.device_get(leaf))
                  for key, leaf in _flat(state)}
        if is_coordinator():
            self._write(int(step), arrays)
        _barrier(f"checkpoint save {int(step)}")

    def _write(self, step: int, arrays: dict) -> None:
        final = self.directory / str(step)
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        with open(tmp / _STATE, "wb") as f:
            np.savez(f, **arrays)
        if final.exists():  # re-save of a step: replace it whole
            shutil.rmtree(final)
        os.replace(tmp, final)

    def restore(self, step: int, template):
        """The state saved at ``step``, shaped like ``template``."""
        _barrier(f"checkpoint restore {int(step)}")
        with np.load(self.directory / str(int(step)) / _STATE,
                     allow_pickle=False) as blob:
            keys = set(blob.files)
            leaves = []
            for key, ref in _flat(template):
                if key not in keys:
                    raise KeyError(f"checkpoint step {step} has no leaf {key}")
                value = blob[key]
                if np.shape(ref) != value.shape:
                    raise ValueError(f"leaf {key}: checkpoint shape "
                                     f"{value.shape} != template {np.shape(ref)}")
                sharding = getattr(ref, "sharding", None)
                value = value.astype(getattr(ref, "dtype", value.dtype))
                # a single-device leaf comes back uncommitted, free to join
                # a mesh-wide computation as the template leaf was
                if isinstance(sharding, SingleDeviceSharding):
                    sharding = None
                leaves.append(jax.device_put(value, sharding))
        treedef = jax.tree_util.tree_structure(template)
        return jax.tree_util.tree_unflatten(treedef, leaves)
