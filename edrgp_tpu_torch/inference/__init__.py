"""Optimizers: L-BFGS (ML-II) with restarts."""

from .lbfgs import LBFGSResult, minimize, minimize_restarts

__all__ = ["LBFGSResult", "minimize", "minimize_restarts"]
