"""Optimizers and samplers: L-BFGS (ML-II) with restarts, HMC, NUTS, SMC."""

from .hmc import hmc_step, run_hmc, run_hmc_pytree
from .lbfgs import LBFGSResult, minimize, minimize_restarts
from .nuts import nuts_step, run_nuts, run_nuts_pytree
from .smc import ess, run_smc, run_smc_pytree, systematic_resample

__all__ = [
    "LBFGSResult", "minimize", "minimize_restarts",
    "run_hmc", "run_hmc_pytree", "hmc_step",
    "run_nuts", "run_nuts_pytree", "nuts_step",
    "run_smc", "run_smc_pytree", "systematic_resample", "ess",
]
