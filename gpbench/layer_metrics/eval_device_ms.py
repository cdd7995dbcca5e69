"""Device time an objective evaluation took: the union of the device's
operations over the traced window (profiler), over the evaluations made in
it (layer: the objective's value and gradient)."""


def read(rec):
    evals = rec.probe.evals
    if not evals:
        return None
    busy = rec.busy_s()
    return 1e3 * busy / evals if busy > 0 else None
