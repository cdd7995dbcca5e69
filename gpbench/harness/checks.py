"""The verdict on a run's readings: each number compared beside its limit
(``limits/<cell>.json``).  What is read, and how, is the traffic mix's
(``mixes/<generator>.py``)."""

from __future__ import annotations

import math


def verdict(readings: dict, limits: dict,
            required: tuple = ()) -> tuple[bool, int, dict]:
    """(correct, failed, checks): each number compared beside its limit;
    a number over its limit, or one not finite, fails.  A run that read
    none of ``required`` compared nothing that matters, and is not correct.
    A number with no limit is read and not compared."""
    checks, failed = {}, 0
    for name, limit in limits.items():
        if name not in readings:
            continue
        value = readings[name]
        checks[name] = {"reading": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            failed += 1
    correct = failed == 0 and all(name in checks for name in required)
    return correct, failed, checks
