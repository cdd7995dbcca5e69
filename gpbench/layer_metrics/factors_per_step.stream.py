"""Cholesky factorizations an SVGP step made in the traced window: the
program's counter ``ops.linalg.FACTORS`` (each ``cholesky_ex`` of the
jitter ladder, one a rung, and each factor recomputed on the autograd
graph) over the steps (layer: factorizations and solves)."""


def read(rec):
    p = rec.probe
    steps = getattr(p, "steps", 0)
    return p.factors / steps if steps else None
