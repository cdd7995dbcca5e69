"""Structured per-step metrics and rank-0 logging, and sampler diagnostics.

The port of :mod:`edrgp_tpu.metrics`: JSONL metric streams written only by
process 0 of a multi-process run (the rank comes from ``torch.distributed``
when it is initialised, else 0), and the split-R̂ and bulk-ESS summaries of
MCMC draws, in numpy.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional

import numpy as np

__all__ = ["MetricsLogger", "is_host0", "effective_sample_size",
           "potential_scale_reduction"]


def is_host0() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class MetricsLogger:
    """Append-only JSONL metrics stream, silent on non-zero ranks."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 flush_every: int = 1):
        self._active = is_host0()
        self._file = None
        if self._active:
            if path is not None:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._file = open(path, "a")
            else:
                self._file = stream or sys.stderr
        self._flush_every = flush_every
        self._count = 0
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        if not self._active:
            return
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            record[k] = v
        self._file.write(json.dumps(record) + "\n")
        self._count += 1
        if self._count % self._flush_every == 0:
            self._file.flush()

    def close(self):
        if self._file is not None and self._file not in (sys.stderr,
                                                         sys.stdout):
            self._file.close()


def effective_sample_size(chains: np.ndarray) -> np.ndarray:
    """Bulk ESS per dimension from [n_chains, n_samples, D] draws
    (Geyer initial-positive-sequence estimator)."""
    chains = np.asarray(chains)
    if chains.ndim == 2:
        chains = chains[None]
    C, S, D = chains.shape
    out = np.empty(D)
    for d in range(D):
        x = chains[:, :, d]
        x = x - x.mean(axis=1, keepdims=True)
        # chain-averaged autocorrelation via FFT
        nfft = 1 << (2 * S - 1).bit_length()
        f = np.fft.rfft(x, nfft, axis=1)
        acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :S].real
        acov /= np.arange(S, 0, -1)
        rho = acov.mean(0) / max(acov.mean(0)[0], 1e-300)
        # Geyer: sum consecutive pairs while positive
        tau = 1.0
        for k in range(1, S - 1, 2):
            pair = rho[k] + rho[k + 1]
            if pair < 0:
                break
            tau += 2 * pair
        out[d] = C * S / tau
    return out


def potential_scale_reduction(chains: np.ndarray) -> np.ndarray:
    """Split-R̂ per dimension from [n_chains, n_samples, D] draws."""
    chains = np.asarray(chains)
    C, S, D = chains.shape
    half = S // 2
    split = np.concatenate([chains[:, :half], chains[:, half:2 * half]],
                           axis=0)                     # [2C, half, D]
    W = split.var(axis=1, ddof=1).mean(axis=0)
    B = half * split.mean(axis=1).var(axis=0, ddof=1)
    var_plus = (half - 1) / half * W + B / half
    return np.sqrt(var_plus / np.maximum(W, 1e-300))
