"""Checkpoint/resume for the inverse-rendering loop (SURVEY.md §5).

The reference renders once and exits (src/render.cpp:72-92); the recovery
loop (BASELINE.json config 4) needs resumable state: params + Adam moments
+ RNG key + iteration. Each checkpoint is one NumPy .npz file, written
to a temporary name and renamed into place.
"""

from __future__ import annotations

import pathlib

import jax
import numpy as np

from drt_tpu.optim import TrainState

_PREFIX = "step_"


def save(path: str, state: TrainState, key) -> None:
    """Persist a TrainState and RNG key (atomic rename)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    flat, treedef = jax.tree.flatten(state)
    payload = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(flat)}
    payload["key_data"] = np.asarray(jax.random.key_data(key))
    tmp = p.parent / (p.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    tmp.rename(p)


def restore(path: str, like: TrainState):
    """Restore (TrainState, key) saved by `save`. `like` supplies the
    pytree structure (build it with optim.init_state on init params)."""
    with np.load(path) as data:
        flat, treedef = jax.tree.flatten(like)
        leaves = [data[f"leaf_{i}"] for i in range(len(flat))]
        key = jax.random.wrap_key_data(data["key_data"])
    return jax.tree.unflatten(treedef, leaves), key


def step_path(directory: str, step: int) -> pathlib.Path:
    """The checkpoint file for `step` under `directory`."""
    return pathlib.Path(directory) / f"{_PREFIX}{step:08d}.npz"


def latest_step(directory: str) -> int | None:
    """The newest step checkpointed under `directory`, or None."""
    d = pathlib.Path(directory)
    if not d.is_dir():
        return None
    steps = [int(p.stem[len(_PREFIX):]) for p in d.glob(f"{_PREFIX}*.npz")
             if p.stem[len(_PREFIX):].isdigit()]
    return max(steps) if steps else None
