"""Numerical engine: kernels, linalg, exact GP math, CUDA kernels."""

from . import exact, kernels, linalg  # noqa: F401
from .kernels import KERNEL_REGISTRY, Kernel, make_kernel

__all__ = ["exact", "kernels", "linalg", "Kernel", "make_kernel",
           "KERNEL_REGISTRY"]
