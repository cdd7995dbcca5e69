"""Least time an H100 could take for each hand-written RBF kernel's work:
the larger of its bytes over the HBM rate and its float32 operations over
the float32 peak, with each input read once and each output written once.

A frozen copy of the arithmetic of ``chip_smoke.kernel_bound``.  Operations
a pair: for K and A the distance is Q subtractions and Q FMAs (3Q), for G a
dot product of Q FMAs (2Q) beside the rows' and columns' norms (2Q a row);
G and A add Q FMAs for the weighted sum (2Q), and each kernel a few scalar
operations around the exp (for G the norms' sum, an FMA, the weight and
the row sum: 5).
"""

from __future__ import annotations

from .peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def work(name: str, rows: int, cols: int, q: int) -> tuple[float, float]:
    """(bytes, flops) of one launch of kernel ``name`` — "K", "A" or "G" —
    over a rows × cols pair grid at Q columns."""
    if name == "K":
        read, write = (rows + cols) * q * 4, rows * cols * 4
        flops = (3 * q + 2) * rows * cols
    elif name == "G":
        read, write = (rows * q + cols * q + cols) * 4, rows * q * 4
        flops = (4 * q + 5) * rows * cols + 2 * q * (rows + cols)
    elif name == "A":
        read, write = (rows * cols + rows * q) * 4, rows * (q + 1) * 4
        flops = (5 * q + 4) * rows * cols
    else:
        raise ValueError(f"unknown kernel {name!r}")
    return float(read + write), float(flops)


def bound_s(name: str, rows: int, cols: int, q: int) -> float:
    """Seconds of the roofline bound of one launch."""
    nbytes, flops = work(name, rows, cols, q)
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
