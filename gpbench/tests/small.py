"""Cells cut to a size a CPU test holds (the program then runs in
float64, its CPU type)."""

import os

from harness.manifest import Manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SIZES = {"exact_edr": {"n_rows": 240}}


def small(workload: str):
    """(manifest, cell, config) with the configuration cut to a CPU size."""
    m = Manifest(ROOT)
    cell = m.cell(workload)
    return m, cell, dict(m.config(cell), **SIZES[workload])
