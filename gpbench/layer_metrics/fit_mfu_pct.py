"""The whole fit step's share of the card's float32 peak: the operations
the window's objective evaluations need (``counts/<config flops>.py``, at
each fit's width), over the traced window's wall time times the peak
(layer: the whole fit step)."""

from counts.peaks import FP32_FLOPS_PER_S


def read(rec):
    flops = sum(f.evals * rec.flops(rec.config, f.q) for f in rec.probe.fits)
    if not flops or rec.window_s <= 0:
        return None
    return 100.0 * flops / (rec.window_s * FP32_FLOPS_PER_S)
