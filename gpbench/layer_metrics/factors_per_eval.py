"""Cholesky factorizations an objective evaluation made in the traced
window: one where the factor succeeds at once, one more for each rung the
jitter ladder climbs where float32 fails it (layer: factorizations and
solves).  Counted by the benchmark's wrapper of ``torch.linalg.cholesky_ex``
inside the evaluations."""


def read(rec):
    p = rec.probe
    if p is None or not p.evals:
        return None
    return p.factors / p.evals
