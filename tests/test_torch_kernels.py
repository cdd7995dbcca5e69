"""The port's RBF kernels (edrgp_tpu_torch.ops.cuda.rbf) against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode, float32, at the shapes of
tests/test_pallas.py, with that file's tolerance (rtol = atol = 2e-4).  The
hand-written CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
from edrgp_tpu.ops.pallas import rbf as jrbf
from edrgp_tpu_torch.ops.cuda import _build
from edrgp_tpu_torch.ops.cuda import rbf as trbf

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(257, 513, 3), (135, 135, 4)]


def _inputs(M, N, Q, ard, seed=0):
    rng = np.random.default_rng(seed)
    X1 = rng.normal(size=(M, Q)).astype(np.float32)
    X2 = rng.normal(size=(N, Q)).astype(np.float32)
    ls = (rng.uniform(0.5, 2.0, Q) if ard else np.array(1.3)).astype(
        np.float32)
    alpha = rng.normal(size=N).astype(np.float32)
    Wm = rng.normal(size=(N, N))
    W = (Wm + Wm.T).astype(np.float32)
    return X1, X2, ls, alpha, W


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("ard", [True, False])
@pytest.mark.parametrize("M,N,Q", SHAPES)
def test_kernel_matrix_plain_matches_pallas(M, N, Q, ard):
    X1, X2, ls, _, _ = _inputs(M, N, Q, ard)
    ref = jrbf.rbf_kernel_matrix(X1 / ls, X2 / ls, 1.7, interpret=True)
    got = trbf.rbf_kernel_matrix(_t(X1 / ls), _t(X2 / ls), 1.7)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("ard", [True, False])
@pytest.mark.parametrize("M,N,Q", SHAPES)
def test_grad_mu_plain_matches_pallas(M, N, Q, ard):
    X1, X2, ls, alpha, _ = _inputs(M, N, Q, ard)
    ref = jrbf.rbf_grad_mu(X1, X2, alpha, ls, 0.8, interpret=True)
    got = trbf.rbf_grad_mu(_t(X1), _t(X2), _t(alpha), _t(ls), 0.8)
    assert got.shape == (M, Q)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("ard", [True, False])
@pytest.mark.parametrize("M,N,Q", SHAPES)
def test_nlml_adjoint_plain_matches_pallas(M, N, Q, ard):
    _, X, ls, _, W = _inputs(M, N, Q, ard)
    # The adjoint defaults to precision="high", the TPU's 3-pass bf16 split,
    # which drops the lo·lo term (~1e-5 relative per product); "default" is
    # the exact float32 product in interpret mode, the math the port runs.
    P_ref, r_ref = jrbf.rbf_nlml_adjoint(X, W, ls, 1.3, interpret=True,
                                         precision="default")
    P, r = trbf.rbf_nlml_adjoint(_t(X), _t(W), _t(ls), 1.3)
    assert P.shape == (N, Q) and r.shape == (N,)
    np.testing.assert_allclose(P.numpy(), np.asarray(P_ref), **TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), **TOL)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    X1, X2, ls, alpha, W = _inputs(9, 11, 2, True)
    trbf.reset_launches()
    trbf.rbf_kernel_matrix(_t(X1), _t(X2), 1.0)
    trbf.rbf_grad_mu(_t(X1), _t(X2), _t(alpha), _t(ls), 1.0)
    trbf.rbf_nlml_adjoint(_t(X2), _t(W), _t(ls), 1.0)
    assert trbf.LAUNCHES == {"rbf_kernel_matrix": 0, "rbf_grad_mu": 0,
                             "rbf_nlml_adjoint": 0}


def test_other_devices_raise_instead_of_falling_back():
    X = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        trbf.rbf_kernel_matrix(X, X, 1.0)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        trbf.rbf_kernel_matrix(torch.zeros(3, 2), torch.zeros(4, 3), 1.0)
    with pytest.raises(ValueError):
        trbf.rbf_nlml_adjoint(torch.zeros(3, 2), torch.zeros(4, 4), 1.0, 1.0)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("rows,N", [
    *(pytest.param(N, N, id=str(N))
      for N in (1, 63, 64, 65, 8192, 10_000)),
    *(pytest.param(rows, N, id=f"{rows}x{N}")
      for rows, N in ((102_400, 8192), (1_048_576, 512), (100, 4000),
                      (20_000, 700), (1, 8192)))])
def test_adjoint_split_covers_every_column_once(rows, N, sms):
    """The contraction kernel's column ranges [s·cols, (s+1)·cols) ∩ [0, N)
    for ``rows`` rows (N for A, the M test rows for G): tile-aligned, none
    empty, every column in exactly one; one split once the row tiles
    alone fill two waves."""
    tile = 64
    splits, cols = trbf.column_split(rows, N, sms, tile)
    assert splits >= 1 and cols > 0 and cols % tile == 0
    covered = np.zeros(N, dtype=int)
    for s in range(splits):
        lo, hi = s * cols, min((s + 1) * cols, N)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    row_tiles = -(-rows // tile)
    if sms == 132 and min(rows, N) >= 8192:   # two waves on an H100
        assert splits * row_tiles >= 2 * sms
    if row_tiles >= 2 * sms:
        assert splits == 1


def test_column_split_of_a_square_plans_as_the_adjoint_did():
    """For A (rows = columns = N) the shared planner gives the splits that
    the adjoint's own planner gave, and no training rows plan one split
    over an empty range."""
    def adjoint_plan(N, sms, tile):
        tiles = max(1, -(-N // tile))
        want = min(tiles, max(1, -(-2 * sms // tiles)))
        per = -(-tiles // want)
        return -(-tiles // per), per * tile

    for N in [*range(1, 700, 7), 4097, 4100, 8191, 8192, 10_000, 65_536]:
        for sms in (1, 78, 132):
            assert trbf.column_split(N, N, sms, 64) == adjoint_plan(N, sms, 64)
    assert trbf.column_split(300, 0, 132, 64) == (1, 64)


def test_library_is_named_after_its_source(tmp_path):
    """A changed source builds a new library instead of loading a stale
    one; the same source names the same library.  Needs no nvcc."""
    src = tmp_path / "rbf.cu"
    src.write_text("// one\n")
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("librbf-") and first.suffix == ".so"
    src.write_text("// two\n")
    assert _build.library_path(src) != first
    assert _build.library_path() != first


def test_build_raises_without_a_toolkit(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
