"""Share of the device's time in the traced window of a streamed SVGP fit
spent in the vendor libraries' kernels (cuSOLVER's potrf, cuBLAS's trsm
and GEMM), read as ``linalg_pct.fit`` reads it (layer: factorizations and
solves)."""

from harness.manifest import load_module

read = load_module("layer_metrics", "linalg_pct.fit.py").read
