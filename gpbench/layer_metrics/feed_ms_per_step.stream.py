"""Host time an SVGP step spent on its data in the traced window: the
program's ``svgp.loader`` spans (the gather of a chunk's batches from the
loader) and ``svgp.feed`` spans (their copy to the device), in ms, over the
steps (layer: data path)."""

SPANS = ("svgp.loader", "svgp.feed")


def read(rec):
    steps = getattr(rec.probe, "steps", 0)
    t0, t1 = rec.t0_ns, rec.t1_ns
    ns = sum(min(e, t1) - max(s, t0) for n, s, e in rec.host_events
             if n in SPANS and e > t0 and s < t1)
    return 1e-6 * ns / steps if steps and ns else None
