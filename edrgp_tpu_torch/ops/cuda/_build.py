"""Build and load the hand-written CUDA kernels (``rbf.cu``).

``nvcc`` compiles ``rbf.cu`` for Hopper (``sm_90a``) into a shared library
with a plain C interface, loaded with :mod:`ctypes`; nothing includes
PyTorch's headers, so a build takes seconds.  The library goes to
``build/edrgp_tpu_torch/`` beside the package, named after a hash of the
source and the compiler flags (:func:`library_path`): a changed source or
flag builds a new library and never loads one built from other code.
Nothing here runs at import: the first kernel launch calls :func:`load`.  A
missing toolkit, a failed compile or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).with_name("rbf.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "edrgp_tpu_torch"
ARCH = "arch=compute_90a,code=sm_90a"
FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v")

#: ptxas's report (registers, shared memory, spills) of the last build made by
#: this process; empty when the library was already built.
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


def library_path(source: Path = SOURCE) -> Path:
    """The library built from ``source`` with :data:`FLAGS`:
    ``librbf-<first 12 hex digits of the SHA-1 of both>.so``."""
    digest = hashlib.sha1(source.read_bytes())
    digest.update("\0".join(FLAGS).encode())
    return BUILD_DIR / f"librbf-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``rbf.cu`` unless its library exists; returns its path."""
    global build_log
    library = library_path()
    if library.exists():
        return library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, library)     # atomic: a reader never sees half a file
    finally:
        if tmp.exists():
            tmp.unlink()
    build_log = proc.stderr
    return library


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edrgp_rbf_kernel_matrix.argtypes = [p, p, p, p, i, i, i, p]
    lib.edrgp_rbf_grad_mu.argtypes = [p, p, p, p, p, p, p, i, p, i, p, i, i,
                                      i, i, i, p]
    lib.edrgp_rbf_nlml_adjoint.argtypes = [p, i, p, p, p, p, p, i, i, i, i,
                                           p]
    lib.edrgp_rbf_contract_tile.argtypes = []
    lib.edrgp_rbf_grad_mu_resident.argtypes = [i]
    for fn in (lib.edrgp_rbf_kernel_matrix, lib.edrgp_rbf_grad_mu,
               lib.edrgp_rbf_nlml_adjoint, lib.edrgp_rbf_contract_tile,
               lib.edrgp_rbf_grad_mu_resident):
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
