"""The streamed SVGP fit step's share of the card's float32 peak: the
window's steps (the program's counter) times the operations one step needs
(``counts/svgp_step.py``), over the traced window's wall time times the
peak (layer: the whole fit step)."""

from counts.peaks import FP32_FLOPS_PER_S


def read(rec):
    steps = getattr(rec.probe, "steps", 0)
    if not steps or rec.flops is None or rec.window_s <= 0:
        return None
    flops = steps * rec.flops(rec.config)
    return 100.0 * flops / (rec.window_s * FP32_FLOPS_PER_S)
