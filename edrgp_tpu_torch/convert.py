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

The samplers and the Bayesian regressor work on flat vectors θ in the
order ``jax.flatten_util.ravel_pytree`` gives ``{"kernel": …, "raw_noise":
…}`` (:func:`edrgp_tpu_torch.ops.exact.theta_layout`); :func:`theta_from_jax`
and :func:`theta_to_jax` map one such vector to and from the pytree, and a
JAX ``BayesianGPModel``'s ``samples_`` are already in that order
(:func:`samples_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy", "theta_from_jax",
           "theta_to_jax", "samples_from_jax"]


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


def theta_from_jax(params_np, kernel) -> np.ndarray:
    """``{"kernel": …, "raw_noise": …}`` with numpy leaves → θ [D] in the
    layout of ``kernel`` (a port kernel of the same structure)."""
    from .ops.exact import theta_layout
    flat = params_from_jax(params_np)
    parts = [flat["kernel." + name].numpy().reshape(-1)
             for name, _ in theta_layout(kernel)]
    return np.concatenate(parts + [flat["raw_noise"].numpy().reshape(1)])


def theta_to_jax(theta, kernel) -> dict:
    """θ [D] → ``{"kernel": …, "raw_noise": …}`` with numpy leaves (tuples
    for the parts of a sum or product)."""
    from .ops.exact import unflatten_theta
    params, raw_noise = unflatten_theta(
        kernel, torch.as_tensor(np.asarray(theta, np.float64))[None])
    out: dict = {}
    for path, value in params.items():
        *parents, leaf = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value[0].numpy()
    return {"kernel": _tuples(out), "raw_noise": raw_noise[0].numpy()}


def samples_from_jax(samples, kernel) -> torch.Tensor:
    """A JAX ``BayesianGPModel.samples_`` [S, D] → the port's samples (the
    same numbers: both packages lay θ out alike), checked against the
    width of ``kernel``'s θ."""
    from .ops.exact import theta_layout
    samples = torch.tensor(np.asarray(samples, np.float64))
    width = sum(s.numel() for _, s in theta_layout(kernel)) + 1
    if samples.ndim != 2 or samples.shape[1] != width:
        raise ValueError(f"samples of shape {tuple(samples.shape)}; the "
                         f"kernel and the noise take {width} entries")
    return samples
