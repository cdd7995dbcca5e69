"""Build and load the hand-written CUDA kernels (``rbf.cu``).

``nvcc`` compiles ``rbf.cu`` for Hopper (``sm_90a``) into a shared library
with a plain C interface, loaded with :mod:`ctypes`; nothing includes
PyTorch's headers, so a build takes seconds.  The library goes to
``build/edrgp_tpu_torch/`` beside the package and is rebuilt only when the
source is newer than it.  Nothing here runs at import: the first kernel
launch calls :func:`load`.  A missing toolkit, a failed compile or a failed
load raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).with_name("rbf.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "edrgp_tpu_torch"
LIBRARY = BUILD_DIR / "librbf.so"
ARCH = "arch=compute_90a,code=sm_90a"

#: ptxas's report (registers, shared memory, spills) of the last build made by
#: this process; empty when the library was already up to date.
build_log = ""

_lib = None


def nvcc_path() -> str:
    """``nvcc`` under ``CUDA_HOME``, or under PyTorch's idea of it."""
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if not home:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME to the "
                           "directory that holds bin/nvcc")
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build() -> Path:
    """Compile ``rbf.cu`` unless the library is newer; returns its path."""
    global build_log
    if (LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, LIBRARY)     # atomic: a reader never sees half a file
    finally:
        if tmp.exists():
            tmp.unlink()
    build_log = proc.stderr
    return LIBRARY


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edrgp_rbf_kernel_matrix.argtypes = [p, p, p, p, i, i, i, p]
    lib.edrgp_rbf_grad_mu.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.edrgp_rbf_nlml_adjoint.argtypes = [p, p, p, p, p, i, i, p]
    for fn in (lib.edrgp_rbf_kernel_matrix, lib.edrgp_rbf_grad_mu,
               lib.edrgp_rbf_nlml_adjoint):
        fn.restype = i
    lib.edrgp_error_string.argtypes = [i]
    lib.edrgp_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(build())))
    return _lib
