"""edrgp_tpu_torch — effective dimensionality reduction with Gaussian
processes in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of :mod:`edrgp_tpu`, which stays the reference.  It imports
neither JAX nor scikit-learn nor the JAX package, and does what it does: the
exact-GP EDR main path (Cholesky NLML with the trace-form adjoint, L-BFGS
ML-II with restarts, predictive gradients, SVD, the iterative and block EDR
with normalization); the kernel zoo (stationary, periodic, linear,
polynomial, MLP, sums, products, ``active_dims``); prior mean functions;
save/load; and the sparse regressor (Titsias SGPR with inducing inputs,
uncertain inputs through the RBF psi statistics) behind
``models.SparseGaussianProcessRegressor``; minibatch SVGP with natural
gradients behind ``models.SVGPRegressor``, trained from memory or streamed
from disk by a native loader (``data``); binary GP classification (VI, EP,
sparse VI, EP-DTC) behind ``models.GaussianProcessClassifier`` and
``models.SparseGaussianProcessClassifier``; and the heteroscedastic
regressor ``models.GaussianProcessHeteroscedasticRegressor``; the HMC,
NUTS and SMC samplers (``inference``) and the fully Bayesian regressor
``models.BayesianGaussianProcessRegressor``; the multi-device layer
(``parallel``) and the runtime around it (``checkpoint``, ``profiling``);
its own PCA and SparsePCA (``decomposition``) for the EDR's DR method,
preprocessor and sparse refit; and the entry points ``entry.entry`` and
``entry.dryrun_multichip``.
"""

from .edr.base import BaseEDR, BlockEDR, IterativeEDR
from .edr.edr import EffectiveDimensionalityReduction
from .utils import (SVDTransformer, discrepancy, ort_space,
                    subspace_variance_ratio)

__version__ = "0.1.0"

__all__ = [
    "EffectiveDimensionalityReduction",
    "BlockEDR",
    "IterativeEDR",
    "BaseEDR",
    "SVDTransformer",
    "discrepancy",
    "ort_space",
    "subspace_variance_ratio",
]
