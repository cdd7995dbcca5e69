"""Share of the traced window in which no operation ran on the device
(profiler; layer: the device)."""


def read(rec):
    window = (rec.t1_ns - rec.t0_ns) / 1e9
    busy = rec.busy_s()
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (window - busy) / window
