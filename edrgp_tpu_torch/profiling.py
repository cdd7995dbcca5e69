"""Profiling and timing harness.

The port of :mod:`edrgp_tpu.profiling`.  ``trace`` wraps ``torch.profiler``
and writes a Chrome trace (open it in ``chrome://tracing`` or Perfetto);
``time_compiled`` separates the first call (on the card: the kernels' build
and first launch) from the steady state, fenced by
``torch.cuda.synchronize`` when the card is in use.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "time_compiled", "flops_estimate_nlml"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and the card's kernels when CUDA is
    available) and write ``<logdir>/trace.json``; yields the profiler.

    The card is synchronized before the profiler starts and before it
    stops, so the trace holds the block's kernels and no earlier ones.
    Each kernel launch should have its kernel in the trace; PyTorch's
    profiler can record a launch and lose its kernel (on PyTorch 2.11 with
    CUDA 12.8, more of them the longer a process has run the samplers).
    The trace is written all the same; fewer kernels than launches warns,
    and launches with no kernel at all raise ``RuntimeError``.
    """
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _fence()
    with profile(activities=activities) as prof:
        yield prof
        _fence()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if ProfilerActivity.CUDA in activities:
        launches, kernels = _launches_and_kernels(prof.events())
        if launches and not kernels:
            raise RuntimeError(f"{path}: the profiler recorded {launches} "
                               "kernel launches but no kernel on the card")
        if kernels < launches:
            warnings.warn(f"{path}: the profiler recorded {launches} kernel "
                          f"launches but {kernels} kernels", RuntimeWarning)


def _launches_and_kernels(events) -> tuple:
    """Kernel launches (runtime and driver calls) and kernels on the card
    (not copies or fills) among a profiler's events."""
    launches = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                   for e in events)
    kernels = sum(e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset"))
                  for e in events)
    return launches, kernels


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_compiled(fn: Callable, *args, iters: int = 20,
                  warmup: int = 1) -> dict:
    """Time the first call of ``fn(*args)`` apart, warm up, then measure
    the steady-state latency over ``iters`` calls.

    Returns {"compile_s", "mean_s", "per_s"}; every span ends in a
    synchronize of the card.
    """
    _fence()
    t0 = time.perf_counter()
    fn(*args)
    _fence()
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        fn(*args)
    _fence()

    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _fence()
    mean_s = (time.perf_counter() - t0) / iters
    return {"compile_s": compile_s, "mean_s": mean_s, "per_s": 1.0 / mean_s}


def flops_estimate_nlml(n: int, q: int) -> float:
    """Rough FLOP count of one NLML+grad eval: K build O(N²Q) + Cholesky
    N³/3 + solve/VJP ≈ 3× forward factorization."""
    k_build = 2.0 * n * n * q
    chol = n ** 3 / 3.0
    return k_build + 4.0 * chol
