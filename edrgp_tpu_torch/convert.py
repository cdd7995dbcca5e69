"""Parameters between the JAX package's pytrees and the port's modules.

A JAX parameter pytree is a nested dict of arrays, e.g. ``{"kernel":
{"variance": a, "lengthscale": b}, "raw_noise": c}``; the port's modules
name the same tensors ``kernel.variance``, ``kernel.lengthscale`` and
``raw_noise`` in their ``state_dict()``.  Both sides hold unconstrained
values, so a round trip is exact.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(params_np, prefix: str = "") -> dict:
    """Nested dict of arrays (numpy leaves) → flat ``state_dict`` of
    float64 CPU tensors keyed by dotted paths; ``load_state_dict`` casts
    them to the module's dtype and device."""
    out = {}
    for key, value in params_np.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(params_from_jax(value, prefix=path + "."))
        else:
            out[path] = torch.as_tensor(np.array(value, dtype=np.float64))
    return out


def params_to_numpy(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` → nested dict of numpy arrays (the JAX
    pytree layout)."""
    out: dict = {}
    for path, value in module.state_dict().items():
        *parents, leaf = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy()
    return out
