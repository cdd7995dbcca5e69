"""Device meshes over the ranks of a process group.

The port of :mod:`edrgp_tpu.parallel.mesh` onto
``torch.distributed.device_mesh``.  The parallelism axes for this model
class are ``chain`` (NUTS/HMC chains), ``data`` (SVGP minibatch rows, the
exact GP's row slabs) and ``particle`` (SMC).  A mesh lays the ranks of the
default group out on named dimensions; each rank holds one position, and a
dimension's process group (``mesh.get_group(name)``) holds the ranks that
differ only along it.  Where the JAX package places a sharded array with a
``NamedSharding``, a rank here holds its own contiguous slab
(:func:`shard_along`) and the sharded functions take that slab.  A
replicated value (the JAX package's ``replicated``) needs no placement:
each rank holds it whole and keeps it equal to the others' (check it with
:func:`~edrgp_tpu_torch.parallel.distributed.assert_replicas_agree`).

An axis argument is one dimension's name or a tuple of names, whose
product then acts as one axis (the ranks in row-major order).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "make_hybrid_mesh", "factor_devices", "shard_along",
           "axis_size", "axis_index", "axis_groups"]


def factor_devices(n: int, n_axes: int = 2) -> tuple:
    """Factor n devices into a balanced n_axes-dim grid (largest factors
    first), e.g. 8 → (4, 2), 16 → (4, 4)."""
    dims = [1] * n_axes
    remaining = n
    for i in range(n_axes - 1):
        # largest divisor ≤ sqrt-ish share
        target = int(round(remaining ** (1.0 / (n_axes - i))))
        best = 1
        for d in range(1, remaining + 1):
            if remaining % d == 0 and d <= max(target, 1):
                best = d
        dims[i] = best
        remaining //= best
    dims[-1] = remaining
    dims.sort(reverse=True)
    return tuple(dims)


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "edrgp_tpu_torch.parallel.initialize first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis_names: Sequence[str] = ("chain", "data"),
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """Mesh over every rank of the default group.  With no ``shape`` the
    ranks are factored evenly over the axes (:func:`factor_devices`).
    Every rank must call it, in the same order as its other meshes."""
    device_type = _device_type()
    n = dist.get_world_size()
    if shape is None:
        shape = factor_devices(n, len(axis_names))
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    return init_device_mesh(device_type, tuple(int(d) for d in shape),
                            mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(ici_axis_names: Sequence[str] = ("chain", "data"),
                     dcn_axis_name: str = "host",
                     ici_shape: Optional[Sequence[int]] = None,
                     local_size: Optional[int] = None) -> DeviceMesh:
    """A leading ``host`` dimension over hosts, inner dimensions over each
    host's ranks.

    Put the heavy collectives on the inner dimensions (NVLink within a
    host) and only small reductions on ``host``.  ``local_size`` is the
    number of ranks a host runs (default: ``LOCAL_WORLD_SIZE`` from the
    launcher, else every rank on one host, which gives a size-1 ``host``
    dimension); ranks are numbered host by host, as launchers number them.
    """
    device_type = _device_type()
    n = dist.get_world_size()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % local_size:
        raise ValueError(f"{n} ranks are not evenly spread over hosts of "
                         f"{local_size}")
    if ici_shape is None:
        ici_shape = factor_devices(local_size, len(ici_axis_names))
    if math.prod(ici_shape) != local_size:
        raise ValueError(f"ici shape {tuple(ici_shape)} != {local_size} "
                         "ranks per host")
    return init_device_mesh(
        device_type, (n // local_size,) + tuple(int(d) for d in ici_shape),
        mesh_dim_names=(dcn_axis_name,) + tuple(ici_axis_names))


def _names(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: DeviceMesh, axis) -> int:
    """Ranks along ``axis`` (the product over a tuple of dimensions)."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in _names(axis))


def axis_index(mesh: DeviceMesh, axis) -> int:
    """This rank's position along ``axis``, row-major over a tuple."""
    index = 0
    for a in _names(axis):
        index = (index * mesh.size(mesh.mesh_dim_names.index(a))
                 + mesh.get_local_rank(a))
    return index


def axis_groups(mesh: DeviceMesh, axis) -> list:
    """The process group of each dimension of ``axis``."""
    return [mesh.get_group(a) for a in _names(axis)]


def shard_along(mesh: DeviceMesh, axis, x: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slab of ``x`` along ``dim``, split evenly
    over ``axis``: the port of the JAX package's sharding of dim ``dim``
    over a mesh axis."""
    p = axis_size(mesh, axis)
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"size {n} must be divisible by the {axis!r} axis "
                         f"size {p}")
    rows = n // p
    return x.narrow(dim, axis_index(mesh, axis) * rows, rows)

