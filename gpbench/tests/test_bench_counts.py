"""The shape-derived counts against hand-worked values."""

import pytest

from counts import exact_nlml, rbf_kernels
from counts.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def test_exact_nlml_flops():
    # N = 10, Q = 2: N³/3 + 2N³/3 + 2N² + N² + (3·2+2)N² + (5·2+4)N²
    # = 1000 + 300 + 800 + 1400 = 3500
    assert exact_nlml.flops({"n_rows": 10}, 2) == pytest.approx(3500.0)


def test_exact_nlml_flops_at_the_cell():
    # N = 8,192, Q = 10: N³ = 5.497558e11 dominates.
    f = exact_nlml.flops({"n_rows": 8192}, 10)
    assert f == pytest.approx(8192 ** 3 + (3 + 32 + 54) * 8192 ** 2)


@pytest.mark.parametrize("name,rows,cols,q,nbytes,flops", [
    # K: read (r + c)·Q·4, write r·c·4; (3Q + 2)·r·c
    ("K", 100, 50, 3, (150 * 3 + 5000) * 4, 11 * 5000),
    # A: read (r·c + r·Q)·4, write r·(Q + 1)·4; (5Q + 4)·r·c
    ("A", 100, 50, 3, (5000 + 300 + 400) * 4, 19 * 5000),
    # G: read (r·Q + c·Q + c)·4, write r·Q·4; (4Q + 5)·r·c + 2Q(r + c)
    ("G", 100, 50, 3, (300 + 150 + 50 + 300) * 4, 17 * 5000 + 900),
])
def test_kernel_work(name, rows, cols, q, nbytes, flops):
    assert rbf_kernels.work(name, rows, cols, q) == (nbytes, flops)


def test_kernel_bounds_at_the_cell():
    # K at 8,192², Q = 10: writing 268 MB bounds it (80.1 µs at 3.35
    # TB/s), above 32·8,192² flops (32.1 µs at 67 TFLOP/s).
    n = 8192
    k = rbf_kernels.bound_s("K", n, n, 10)
    assert k == pytest.approx(((2 * n * 10) + n * n) * 4 / HBM_BYTES_PER_S)
    assert k == pytest.approx(8.0e-5, rel=0.01)
    # A reads W once: the same bytes' bound, 80.3 µs.
    a = rbf_kernels.bound_s("A", n, n, 10)
    assert a == pytest.approx((n * n + n * 10 + n * 11) * 4
                              / HBM_BYTES_PER_S)
    # G at 8,192², Q = 10 is bound by its 45·n² flops.
    g = rbf_kernels.bound_s("G", n, n, 10)
    assert g == pytest.approx((45 * n * n + 20 * 2 * n) / FP32_FLOPS_PER_S)
