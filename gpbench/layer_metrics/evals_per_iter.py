"""Objective evaluations an L-BFGS iteration made in the traced window:
the closure's calls that evaluated the objective (not those answered from
the closure's cache), over the iterations completed (layer: ML-II)."""


def read(rec):
    p = rec.probe
    if not p.iterations:
        return None
    return p.evals / p.iterations
