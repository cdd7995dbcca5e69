"""Numerical engine: kernels, linalg, exact, sparse and classification GP
math, CUDA kernels."""

from . import (ep, ep_dtc, exact, kernels, linalg, sgpr, svgp,  # noqa: F401
               uncertain, vgp)
from .kernels import KERNEL_REGISTRY, Kernel, make_kernel, register_kernel

__all__ = ["ep", "ep_dtc", "exact", "kernels", "linalg", "sgpr", "svgp",
           "uncertain", "vgp",
           "Kernel", "make_kernel", "register_kernel", "KERNEL_REGISTRY"]
