"""Operations the device ran in the traced window (kernels, copies and
fills, from the profiler's device records) over the SVGP steps taken in it
(layer: launches)."""


def read(rec):
    steps = getattr(rec.probe, "steps", 0)
    ops = sum(1 for _ in rec.clipped())
    return ops / steps if steps and ops else None
