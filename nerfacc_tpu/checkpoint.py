"""Checkpoint / resume.

The reference has no checkpointing at all (SURVEY §5: no torch.save/load
anywhere); here it is first-class: the whole training state — field
params, optimizer state, occupancy grid (a plain pytree), step — saves to
one ``.npz`` file per step and restores onto a template of the same
structure. A save writes a temporary file and renames it over the final
name, so a crash mid-save never leaves a truncated checkpoint behind.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, List, Optional

import jax
import numpy as np

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")


def _flatten(state: Any):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(state)
    return [jax.tree_util.keystr(p) for p, _ in leaves], [
        v for _, v in leaves
    ], treedef


class CheckpointManager:
    """``save(step, state)`` / ``restore(template)`` over a directory.

    ``state`` is any pytree (dict of params/opt_state/grid/...) whose
    leaves are fully addressable from this process (replicated or
    single-device). Static metadata (grid resolution, contraction type)
    lives in code, not in the checkpoint — grids restore via their arrays
    onto a template. Only process 0 writes; the newest ``max_to_keep``
    checkpoints are kept (None keeps all).
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.npz"

    def all_steps(self) -> List[int]:
        steps = []
        for f in self.directory.iterdir():
            m = _NAME.match(f.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write ``state`` for ``step`` (synchronous; ``wait`` is kept for
        callers of the asynchronous API and has no effect)."""
        if jax.process_index() != 0:
            return
        keys, leaves, _ = _flatten(state)
        arrays = {k: np.asarray(v) for k, v in zip(keys, leaves)}
        final = self._path(step)
        tmp = final.with_name(final.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[: -self.max_to_keep]:
                self._path(old).unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``template`` (names, shapes and
        dtypes must match; placement is taken from the template's
        arrays)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        keys, leaves, treedef = _flatten(template)
        with np.load(self._path(step)) as data:
            missing = sorted(set(keys) ^ set(data.files))
            if missing:
                raise ValueError(
                    f"checkpoint {step} does not match the template: {missing}"
                )
            out = []
            for k, leaf in zip(keys, leaves):
                arr = data[k]
                want = np.shape(leaf)
                if arr.shape != want:
                    raise ValueError(f"{k}: shape {arr.shape} != {want}")
                if isinstance(leaf, jax.Array):
                    out.append(jax.device_put(
                        arr.astype(leaf.dtype), leaf.sharding
                    ))
                elif isinstance(leaf, np.ndarray):
                    out.append(arr.astype(leaf.dtype))
                else:  # python scalar
                    out.append(type(leaf)(arr.item()))
        return jax.tree_util.tree_unflatten(treedef, out)

    def close(self) -> None:
        """Nothing is pending: saves are synchronous."""
