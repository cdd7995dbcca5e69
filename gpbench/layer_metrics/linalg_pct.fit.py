"""Share of the device's time in the traced window spent in the vendor
libraries' kernels (cuSOLVER's factorizations, cuBLAS's solves and
products), told by kernel name (layer: factorizations and solves)."""

import re

#: Kernel names of cuBLAS and cuSOLVER (and the CUTLASS/xmma GEMMs cuBLAS
#: dispatches to).
LIBRARY = re.compile(
    r"gemm|gemv|trsm|trmm|trsv|syrk|herk|syr2k|symm|potrf|potri|potrs|"
    r"trtri|lauum|getrf|getrs|geqrf|orgqr|ormqr|larf|syevd|gesvd|"
    r"cublas|cusolver|magma|xmma|cutlass|dot_kernel|nrm2|axpy|asum|"
    r"scal_kernel|lacpy|laset|chol", re.IGNORECASE)


def read(rec):
    total = lib = 0
    for name, s, e, _ in rec.clipped():
        total += e - s
        if LIBRARY.search(name):
            lib += e - s
    return 100.0 * lib / total if total else None
