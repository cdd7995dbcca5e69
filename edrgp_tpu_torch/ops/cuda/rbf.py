"""The three RBF kernels of the main path: wrappers, plain versions, counts.

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel in ``rbf.cu`` (float32 only; anything
else raises), a CPU tensor takes the plain PyTorch version beside it, which
computes the same function with the JAX package's math.  There is no
fallback: a failed build, load or launch raises.  ``LAUNCHES`` counts the
kernel launches of each wrapper, so a run can show that it went through the
kernels.

=====================  ======================================  =============
wrapper                replaces (edrgp_tpu/ops/pallas/rbf.py)  serves
=====================  ======================================  =============
rbf_kernel_matrix      rbf_kernel_matrix (pallas_call :98)      K(X, X) in the
                                                                NLML forward,
                                                                K(X, X*) in
                                                                predict
rbf_grad_mu            rbf_grad_mu (pallas_call :172)           dμ/dx*
rbf_nlml_adjoint       rbf_nlml_adjoint (pallas_call :262)      NLML backward
=====================  ======================================  =============

K and A also take a batch of chains, the counterpart of ``jax.vmap`` over
the JAX functions (the samplers' NLML, ``ops.exact.nlml_chains``): a leading
chain axis on every input, σ² one per chain, and on the card one launch of
the same kernel per chain, so each chain's bits are those of a single call.
"""

from __future__ import annotations

import functools
import math

import torch

from ..kernels import sq_dist
from . import _build

__all__ = ["rbf_kernel_matrix", "rbf_grad_mu", "rbf_nlml_adjoint",
           "rbf_kernel_matrix_plain", "rbf_grad_mu_plain",
           "rbf_nlml_adjoint_plain", "column_split", "LAUNCHES",
           "reset_launches"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"rbf_kernel_matrix": 0, "rbf_grad_mu": 0, "rbf_nlml_adjoint": 0}

#: Rows of the [rows, N] kernel block the plain dμ/dx* holds at once.
_PLAIN_BLOCK_ELEMS = 1 << 26

#: Blocks per SM the contraction's column split aims for by default (A):
#: at least two waves of one block per SM.  Each split adds a partial
#: (P, r) per row to write and to add up again, so more is not better.
_BLOCKS_PER_SM = 2

#: G fills one wave of the blocks an SM holds at once, to within this share.
_WAVE_FILL = 0.95


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain path); True for float32 CUDA tensors on
    one device (kernel path); raises for anything else."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
    return True


def _lengthscale(lengthscale, Q: int, like: torch.Tensor) -> torch.Tensor:
    """ℓ broadcast to [Q], or to [C, Q] for a chain batch ``like`` [C, N, Q]."""
    if isinstance(lengthscale, torch.Tensor):
        lengthscale = lengthscale.detach()
    ls = torch.as_tensor(lengthscale, dtype=like.dtype, device=like.device)
    return ls.broadcast_to(like.shape[:-2] + (Q,))


def _scalar(sigma2, like: torch.Tensor, chains: int = 1) -> torch.Tensor:
    """σ² as ``chains`` contiguous float32 values on the card (one number
    or one per chain): the kernel reads it there, so the host never waits
    for its value."""
    if isinstance(sigma2, torch.Tensor):
        sigma2 = sigma2.detach()
    return torch.as_tensor(sigma2, dtype=torch.float32,
                           device=like.device).reshape(-1).expand(
                               chains).contiguous()


def _per_matrix(sigma2, like: torch.Tensor):
    """σ² (a number or one per chain) shaped to scale a [C, M, N] batch;
    as it is for a single [M, N] matrix."""
    if like.ndim == 2:
        return sigma2
    return torch.as_tensor(sigma2, dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1)


def _launch(name: str, *args) -> None:
    lib = _build.load()
    code = getattr(lib, "edrgp_" + name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.edrgp_error_string(code).decode()} "
                           f"(cudaError {code})")
    LAUNCHES[name] += 1


def _check_rows(name: str, A: torch.Tensor, B: torch.Tensor,
                chains: bool = False) -> None:
    """[M, Q] and [N, Q]; with ``chains`` also [C, M, Q] and [C, N, Q]."""
    ok = (A.ndim == B.ndim and A.ndim in ((2, 3) if chains else (2,))
          and A.shape[:-2] == B.shape[:-2] and A.shape[-1] == B.shape[-1])
    if not ok:
        raise ValueError(f"{name}: need [M, Q] and [N, Q] inputs"
                         f"{' (or [C, M, Q] and [C, N, Q])' if chains else ''},"
                         f" got {tuple(A.shape)} and {tuple(B.shape)}")


# ---------------------------------------------------------------------------
# K(X1, X2) = σ² exp(−½‖x1 − x2‖²) on pre-scaled inputs
# ---------------------------------------------------------------------------

def rbf_kernel_matrix_plain(X1s, X2s, sigma2):
    """σ²·exp(−½‖x1−x2‖²) for pre-scaled X1s [M, Q], X2s [N, Q] → [M, N]
    (chain batches as :func:`rbf_kernel_matrix`)."""
    return _per_matrix(sigma2, X1s) * torch.exp(-0.5 * sq_dist(X1s, X2s))


def rbf_kernel_matrix(X1s, X2s, sigma2):
    """σ²·exp(−½‖x1−x2‖²) for pre-scaled X1s [M, Q], X2s [N, Q] → [M, N];
    for a chain batch X1s [C, M, Q], X2s [C, N, Q] and σ² a number or [C]
    → [C, M, N], one launch per chain."""
    _check_rows("rbf_kernel_matrix", X1s, X2s, chains=True)
    if not _on_card(X1s, X2s):
        return rbf_kernel_matrix_plain(X1s, X2s, sigma2)
    (M, Q), N = X1s.shape[-2:], X2s.shape[-2]
    x1, x2 = X1s.contiguous(), X2s.contiguous()
    out = torch.empty((*x1.shape[:-1], N), dtype=torch.float32,
                      device=x1.device)
    if M and N:
        x1b, x2b = x1.view(-1, M, Q), x2.view(-1, N, Q)
        outb = out.view(-1, M, N)
        s2 = _scalar(sigma2, x1, outb.shape[0])
        for c in range(outb.shape[0]):
            _launch("rbf_kernel_matrix", x1b[c].data_ptr(),
                    x2b[c].data_ptr(), s2[c].data_ptr(), outb[c].data_ptr(),
                    M, N, Q)
    return out


# ---------------------------------------------------------------------------
# The contraction kernel that A and G share: its column split and inputs
# ---------------------------------------------------------------------------

def column_split(rows: int, cols: int, sms: int, tile: int,
                 blocks_per_sm: float = _BLOCKS_PER_SM) -> tuple[int, int]:
    """(splits, cols_per_split) for the contraction kernel on a card with
    ``sms`` SMs and the kernel's square ``tile``: the ``cols`` columns go to
    ``splits`` ranges of ``cols_per_split`` (a multiple of the tile)
    columns, the last one ragged, so that the rows/tile row tiles times the
    splits give at least ``blocks_per_sm`` blocks per SM, with one split
    once the row tiles alone do.  The ranges cover [0, cols) once, and none
    is empty unless cols is 0."""
    row_tiles = max(1, -(-rows // tile))
    col_tiles = max(1, -(-cols // tile))
    want = min(col_tiles,
               max(1, math.ceil(blocks_per_sm * sms / row_tiles)))
    per = -(-col_tiles // want)
    return -(-col_tiles // per), per * tile


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _contract_tile() -> int:
    """The contraction kernel's tile, as the built library states it."""
    return _build.load().edrgp_rbf_contract_tile()


@functools.lru_cache(maxsize=None)
def _gradmu_resident(Q: int, index: int) -> int:
    """Blocks of G's contraction at this Q that an SM of card ``index``
    holds at once, as the built library computes it."""
    with torch.cuda.device(index):
        return max(1, _build.load().edrgp_rbf_grad_mu_resident(Q))


def _gradmu_split(M: int, N: int, Q: int, index: int) -> tuple[int, int]:
    """G's column split on card ``index``: one wave of the blocks its SMs
    hold at once, short by up to 5% (2 splits at M=N=8,192, Q=10, where an
    SM holds two blocks, instead of 3 that spill a third of the blocks
    into a second wave)."""
    return column_split(M, N, _sm_count(index), _contract_tile(),
                        _WAVE_FILL * _gradmu_resident(Q, index))


# ---------------------------------------------------------------------------
# dμ/dx*: G[m] = Σᵢ αᵢ k(x*_m, xᵢ)(xᵢ − x*_m)/ℓ²
# ---------------------------------------------------------------------------

def rbf_grad_mu_plain(Xnew, X, alpha, lengthscale, sigma2):
    """dμ/dx* [M, Q] of μ(x*) = Σᵢ αᵢ σ² exp(−½‖(x*−xᵢ)/ℓ‖²), computed as
    the TPU kernel does: (Σᵢ Wᵢ xsᵢ − xs* Σᵢ Wᵢ)/ℓ over row blocks."""
    _check_rows("rbf_grad_mu", Xnew, X)
    ls = _lengthscale(lengthscale, X.shape[1], X)
    Xs, Xt = Xnew / ls, X / ls
    rows = max(1, _PLAIN_BLOCK_ELEMS // max(X.shape[0], 1))
    parts = []
    for xs in Xs.split(rows):
        W = rbf_kernel_matrix_plain(xs, Xt, sigma2) * alpha[None, :]
        parts.append(W @ Xt - xs * W.sum(1, keepdim=True))
    return torch.cat(parts) / ls


def rbf_grad_mu(Xnew, X, alpha, lengthscale, sigma2):
    """dμ/dx* [M, Q] for Xnew [M, Q], X [N, Q] unscaled, α [N], ℓ scalar or
    [Q], σ² scalar; never forms the [M, N] cross-kernel on the card."""
    _check_rows("rbf_grad_mu", Xnew, X)
    if alpha.shape != (X.shape[0],):
        raise ValueError(f"alpha must be [{X.shape[0]}], got "
                         f"{tuple(alpha.shape)}")
    if not _on_card(Xnew, X, alpha):
        return rbf_grad_mu_plain(Xnew, X, alpha, lengthscale, sigma2)
    (M, Q), N, dev = Xnew.shape, X.shape[0], X.device
    G = torch.empty((M, Q), dtype=torch.float32, device=dev)
    if not (M and Q):
        return G
    ls = _lengthscale(lengthscale, Q, X).contiguous()
    xn, x, a = (t.detach().contiguous() for t in (Xnew, X, alpha))
    s2 = _scalar(sigma2, x)
    # Scratch: both row sets centred, scaled and transposed by the kernel,
    # with 16-byte aligned rows; α and the training rows' norms ride as
    # rows Q and Q + 1.
    ldr, ldc = -(-M // 4) * 4, -(-N // 4) * 4
    xrT = torch.empty((Q, ldr), dtype=torch.float32, device=dev)
    xcT = torch.empty((Q + 2, ldc), dtype=torch.float32, device=dev)
    splits, cols = _gradmu_split(M, N, Q, dev.index)
    part = torch.empty((splits, M, Q + 1), dtype=torch.float32, device=dev)
    _launch("rbf_grad_mu", xn.data_ptr(), x.data_ptr(), a.data_ptr(),
            ls.data_ptr(), s2.data_ptr(), G.data_ptr(), xrT.data_ptr(), ldr,
            xcT.data_ptr(), ldc, part.data_ptr(), M, N, Q, splits, cols)
    return G


# ---------------------------------------------------------------------------
# NLML adjoint: P = (W∘K)·Xs [N, Q], r = (W∘K)·1 [N]
# ---------------------------------------------------------------------------

def rbf_nlml_adjoint_plain(X, W, lengthscale, sigma2):
    """(P, r) with P = (W∘K)·Xs and r = (W∘K)·1, K = K(Xs, Xs), Xs = X/ℓ
    (chain batches as :func:`rbf_nlml_adjoint`)."""
    ls = _lengthscale(lengthscale, X.shape[-1], X)
    Xs = X / ls[..., None, :]
    A = W * rbf_kernel_matrix_plain(Xs, Xs, sigma2)
    return A @ Xs, A.sum(-1)


def rbf_nlml_adjoint(X, W, lengthscale, sigma2):
    """(P [N, Q], r [N]) for X [N, Q] unscaled and any [N, N] W (the
    cotangent of K); reads W once and recomputes K on the fly.  Rows and
    columns are not symmetrized: the NLML chain rule downstream needs a
    symmetric W.  A chain batch X [C, N, Q], W [C, N, N], ℓ [C, Q] (or
    broadcastable), σ² a number or [C] gives P [C, N, Q], r [C, N], one
    launch per chain."""
    N = X.shape[-2] if X.ndim >= 2 else -1
    if X.ndim not in (2, 3) or W.shape != (*X.shape[:-2], N, N):
        raise ValueError(f"rbf_nlml_adjoint: need X [N, Q] and W [N, N] "
                         f"(or [C, N, Q] and [C, N, N]), got "
                         f"{tuple(X.shape)} and {tuple(W.shape)}")
    if not _on_card(X, W):
        return rbf_nlml_adjoint_plain(X, W, lengthscale, sigma2)
    Q, dev = X.shape[-1], X.device
    C = W.shape[0] if W.ndim == 3 else 1
    ls = _lengthscale(lengthscale, Q, X).reshape(C, Q)
    xb, w = X.detach().reshape(C, N, Q), W.detach().contiguous().view(C, N, N)
    P = torch.empty((*X.shape[:-2], N, Q), dtype=torch.float32, device=dev)
    r = torch.empty(X.shape[:-1], dtype=torch.float32, device=dev)
    if N:
        # The scaled rows transposed, [Q, ldx] a chain with 16-byte aligned
        # rows: the kernel stages a tile's columns from Q contiguous runs.
        # At least one row, so that the kernel always has an aligned
        # address to name.  The chains' launches queue on one stream, so
        # they share the partial sums.
        ldx = -(-N // 4) * 4
        xsT = torch.empty((C, max(Q, 1), ldx), dtype=torch.float32,
                          device=dev)
        torch.div(xb.mT, ls[:, :, None], out=xsT[:, :Q, :N])
        s2 = _scalar(sigma2, X, C)
        splits, cols = column_split(N, N, _sm_count(dev.index),
                                    _contract_tile())
        part = torch.empty((splits, N, Q + 1), dtype=torch.float32,
                           device=dev)
        Pb, rb = P.view(C, N, Q), r.view(C, N)
        for c in range(C):
            _launch("rbf_nlml_adjoint", xsT[c].data_ptr(), ldx,
                    w[c].data_ptr(), s2[c].data_ptr(), Pb[c].data_ptr(),
                    rb[c].data_ptr(), part.data_ptr(), N, Q, splits, cols)
    return P, r
