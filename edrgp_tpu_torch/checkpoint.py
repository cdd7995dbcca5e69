"""Checkpoint / resume for fits, samplers and particle ensembles.

The port of :mod:`edrgp_tpu.checkpoint`, in its file format: one
``ckpt_<step>.npz`` per step holding the tree's leaves as ``leaf_0``,
``leaf_1``, … and a JSON ``__manifest__`` (the leaves' paths, the tree's
structure, the step, the leaf count), written to a temporary file and
renamed into place, so a killed process never leaves a torn checkpoint.
A tree is nested dicts, tuples, lists and named tuples of tensors, arrays
and numbers (hyperparameters, ``SVGPState``, NUTS's ``HMCState`` and
``AdaptState``, particle ensembles), flattened in the JAX package's leaf
order (:mod:`edrgp_tpu_torch._pytree`), so either package loads the
other's checkpoints.  Tensors are saved from wherever they live and loaded
back onto the device and dtype of the tree they are loaded into.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from ._pytree import flatten_with_paths, structure, unflatten_like

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager"]

_STEP_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, tree: Any, step: int) -> str:
    """Atomically write ``tree`` as ``<directory>/ckpt_<step>.npz``."""
    os.makedirs(directory, exist_ok=True)
    flat = flatten_with_paths(tree)
    payload = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in
               enumerate(flat)}
    manifest = {"keys": [path for path, _ in flat],
                "treedef": structure(tree), "step": int(step),
                "num_leaves": len(flat)}
    payload["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)

    final = os.path.join(directory, f"ckpt_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def _steps(directory: str) -> list:
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := _STEP_RE.match(name)))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, tree_like: Any,
                    step: Optional[int] = None) -> tuple[Any, int]:
    """Load a checkpoint into the structure of ``tree_like``: (tree, step).

    ``tree_like`` gives the structure and, for each leaf, the type, dtype
    and device the stored array is cast to; the values come from disk.
    ``step=None`` loads the latest checkpoint.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step}.npz")
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        values = [data[f"leaf_{i}"] for i in range(manifest["num_leaves"])]
    n_like = len(flatten_with_paths(tree_like))
    if n_like != len(values):
        raise ValueError(
            f"checkpoint has {len(values)} leaves; target structure has "
            f"{n_like}")
    return unflatten_like(tree_like, values), step


class CheckpointManager:
    """Keep-the-last-k checkpoint rotation for training loops."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_every: int = 100):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_every = save_every

    def maybe_save(self, tree: Any, step: int) -> Optional[str]:
        if step % self.save_every != 0:
            return None
        path = save_checkpoint(self.directory, tree, step)
        self._gc()
        return path

    def restore_or(self, tree_like: Any, default_step: int = 0):
        """(tree, step) from the latest checkpoint, else (tree_like,
        default_step)."""
        if latest_step(self.directory) is None:
            return tree_like, default_step
        return load_checkpoint(self.directory, tree_like)

    def _gc(self):
        for s in _steps(self.directory)[:-self.max_to_keep]:
            os.unlink(os.path.join(self.directory, f"ckpt_{s}.npz"))
