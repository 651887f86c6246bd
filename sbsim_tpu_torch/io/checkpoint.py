"""Checkpoint / resume for the full training state, without orbax.

Port of sbsim_tpu/io/checkpoint.py. Everything - env states, replay ring,
SAC learner, rng - is one TrainState, so one save captures the whole run
and a restore resumes it exactly. A checkpoint is the nested dict of
`convert.train_state_to_numpy` (the JAX TrainState's field layout) written
with `np.savez` under "/"-joined paths, and read back with
`allow_pickle=False`: loading runs no code. Each save goes to a temporary
name, is synced, and is then renamed, so a step's file is whole or absent.

On a mesh of ranks (distributed/mesh.py) a checkpoint is the same file:
`save` gathers the state's row blocks, rank 0 writes the one-process
archive and every rank waits for it at a barrier; `restore` reads the file
on every rank and takes the rank's rows. So a checkpoint written by N ranks
restores in any number of ranks that divides its envs, one among them.

The JAX package's restore shim for checkpoints written before its EnvState
gained zone_means/grid_mean (`_restore_legacy`) has no counterpart here:
the port has never written that format.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from sbsim_tpu_torch import convert
from sbsim_tpu_torch.distributed import mesh as mesh_lib

_NAME = "step_{:010d}.npz"
_PATTERN = re.compile(r"^step_(\d{10})\.npz$")


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Leaves under "/"-joined paths; an empty dict (optax's EmptyState in a
    chain) as its path with a trailing "/" and an empty array."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) and value:
            out.update(_flatten(value, f"{prefix}{key}/"))
        elif isinstance(value, dict):
            out[f"{prefix}{key}/"] = np.zeros(0, np.uint8)
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        if leaf:
            node[leaf] = value
    return tree


class TrainCheckpointer:
    """Saves/restores TrainState snapshots of `trainer` (an
    agents.train.SACTrainer) under a directory, keeping the newest
    `max_to_keep`. With a `mesh` (distributed/mesh.Mesh) the states are
    sharded over its ranks, and every rank calls save and restore."""

    def __init__(self, directory: str, trainer, max_to_keep: int = 3,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self._directory = os.path.abspath(directory)
        os.makedirs(self._directory, exist_ok=True)
        self._trainer = trainer
        self._max_to_keep = max_to_keep
        self._mesh = mesh if mesh is not None else mesh_lib.Mesh(group=None, rank=0, size=1)

    def _path(self, step: int) -> str:
        return os.path.join(self._directory, _NAME.format(step))

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        found = (_PATTERN.match(n) for n in os.listdir(self._directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state) -> None:
        state = mesh_lib.gather_train_state(state, self._mesh)
        if self._mesh.rank == 0:
            self._write(step, state)
        if self._mesh.group is not None:
            dist.barrier(group=self._mesh.group)

    def _write(self, step: int, state) -> None:
        flat = _flatten(convert.train_state_to_numpy(state, self._trainer))
        final = self._path(step)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.steps()[:-self._max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def read(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved nested dict of numpy arrays (latest step by default)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self._directory}")
        with np.load(self._path(step), allow_pickle=False) as data:
            return _unflatten({k: data[k] for k in data.files})

    def restore(self, template, step: Optional[int] = None):
        """The TrainState saved at `step` (default: the latest), on the
        trainer's device, with this rank's rows on a mesh. `template` (an
        initialized TrainState, sharded as the restored one will be) gives
        the structure: a checkpoint whose paths, shapes or dtypes differ
        from it raises a ValueError."""
        tree = self.read(step)
        flat = _flatten(tree)
        full = mesh_lib.gather_train_state(template, self._mesh)
        want = _flatten(convert.train_state_to_numpy(full, self._trainer))
        if set(flat) != set(want):
            raise ValueError(
                f"checkpoint paths differ from the template's: missing "
                f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}"
            )
        bad = [k for k in want
               if (flat[k].shape, flat[k].dtype) != (want[k].shape, want[k].dtype)]
        if bad:
            raise ValueError(f"checkpoint leaves differ from the template's in shape "
                             f"or dtype: {bad}")
        return mesh_lib.shard_train_state(
            convert.train_state_from_numpy(tree, self._trainer), self._mesh)

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's
        interface."""
