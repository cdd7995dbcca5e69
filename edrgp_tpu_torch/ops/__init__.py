"""Numerical engine: kernels, linalg, exact and sparse GP math, CUDA
kernels."""

from . import exact, kernels, linalg, sgpr, svgp, uncertain  # noqa: F401
from .kernels import KERNEL_REGISTRY, Kernel, make_kernel

__all__ = ["exact", "kernels", "linalg", "sgpr", "svgp", "uncertain",
           "Kernel", "make_kernel", "KERNEL_REGISTRY"]
