"""The control — the reference in float32 with TF32 matmuls, put in the
program's place — comes out not correct against the committed limits: at a
CPU size (TF32 emulated by rounding each matmul's operands), and on the
card at the cell's own size on three seeds (the readings the limits were
set from; ``control.py`` prints them)."""

import pytest

from harness import checks
from harness.cell import run_cell

from small import small


def _control(workload, seeds, seconds, device, config=None):
    m, cell, small_config = small(workload)
    limits = m.limits(cell)
    for seed in seeds:
        out = run_cell(m, cell, seed, seconds, False, device=device,
                       config=config or small_config,
                       sources=("program", "control"))
        yield (checks.verdict(out["readings"]["program"], limits,
                              ("grad",))[0],
               checks.verdict(out["readings"]["control"], limits,
                              ("grad",)))


def test_control_fails_at_a_cpu_size():
    for program_ok, (control_ok, failed, compared) in _control(
            "exact_edr", [7], 3.0, "cpu"):
        assert program_ok
        assert not control_ok and failed >= 2, compared


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    m, cell, _ = small("exact_edr")
    for program_ok, (control_ok, failed, compared) in _control(
            "exact_edr", [11, 12, 13], 10.0, "cuda", m.config(cell)):
        assert program_ok
        assert not control_ok, compared
