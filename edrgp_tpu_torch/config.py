"""Numeric configuration of the PyTorch port: device, working dtype, jitter.

The port of :mod:`edrgp_tpu.config`.  On the CPU it works in float64, the
parity mode of the tests; on CUDA in float32, the card's working type.  Every
public entry point resolves its device through :func:`resolve_device`, which
also refuses to run float32 matmuls at reduced precision.
"""

from __future__ import annotations

import torch

#: Smallest diagonal jitter added before a Cholesky factorization, scaled by
#: the mean diagonal magnitude; escalates 10x per failed attempt (see
#: :func:`edrgp_tpu_torch.ops.linalg.safe_cholesky`).
BASE_JITTER_F32 = 1e-6
BASE_JITTER_F64 = 1e-10

#: Number of jitter escalations attempted before giving up.
MAX_JITTER_TRIES = 6


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card, as ``"cuda"`` does: without CUDA both raise
    instead of falling back to the CPU, which runs only when the caller
    asks for ``"cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        check_matmul_precision()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU (parity runs), float32 on CUDA."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def base_jitter(dtype) -> float:
    return BASE_JITTER_F64 if dtype == torch.float64 else BASE_JITTER_F32


def check_matmul_precision() -> None:
    """Raise unless float32 matmuls run in full float32.

    TF32 keeps about three decimal digits, the Hopper form of the TPU's
    single-pass bf16 hazard: a kernel matrix perturbed at that level turns the
    NLML into a rough surface (see ``edrgp_tpu/config.py``, kernel precision).
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False: TF32 matmuls are too coarse for the GP")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("torch.get_float32_matmul_precision() must be "
                           "'highest' for the GP's float32 matmuls")
