"""Parameters between the JAX package's pytrees and the port's modules.

A JAX parameter pytree is a nested dict of arrays, e.g. ``{"kernel":
{"variance": a, "lengthscale": b}, "raw_noise": c}``; the port's modules
name the same tensors ``kernel.variance``, ``kernel.lengthscale`` and
``raw_noise`` in their ``state_dict()``.  A sum or product kernel's
parameters are a tuple of its parts' dicts in JAX and the parts
``kernels.0``, ``kernels.1``, … of an ``nn.ModuleList`` in the port.  A
named tuple such as the SVGP's ``SVGPState(theta1, theta2)`` maps by its
field names.  Both sides hold unconstrained values, so a round trip is
exact.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(params_np, prefix: str = "") -> dict:
    """Nested dict, tuple or named tuple of arrays with numpy leaves → flat
    ``state_dict`` of float64 CPU tensors keyed by dotted paths;
    ``load_state_dict`` casts them to the module's dtype and device."""
    if hasattr(params_np, "_asdict"):
        items = params_np._asdict().items()
    elif isinstance(params_np, (tuple, list)):
        items = ((f"kernels.{i}", v) for i, v in enumerate(params_np))
    else:
        items = params_np.items()
    out = {}
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, tuple, list)):
            out.update(params_from_jax(value, prefix=path + "."))
        else:
            out[path] = torch.as_tensor(np.array(value, dtype=np.float64))
    return out


def _tuples(node):
    """A node ``{"kernels": {"0": a, "1": b, …}}`` → ``(a, b, …)``,
    recursively: the JAX layout of a sum or product kernel."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    parts = node.get("kernels")
    if set(node) == {"kernels"} and isinstance(parts, dict):
        return tuple(parts[str(i)] for i in range(len(parts)))
    return node


def params_to_numpy(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` → nested dict of numpy arrays (the JAX
    pytree layout, tuples for the parts of a sum or product)."""
    out: dict = {}
    for path, value in module.state_dict().items():
        *parents, leaf = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy()
    return _tuples(out)
