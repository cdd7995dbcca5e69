"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates), which
the shares of a peak or a roofline divide by.  The fit's float32 matmuls
run without TF32, so the float32 rate outside the tensor cores is the
peak that bounds them."""

FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
