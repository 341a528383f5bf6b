"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).

Every share of a peak or of a roofline that the benchmark reports is taken
against these numbers, whatever the program's kernels happen to run on.
"""

# TF32 on the tensor cores: the fastest the card multiplies float32 inputs,
# so no float32-accurate implementation can read a share above 100%.
TF32_FLOPS = 495e12
# Float32 outside the tensor cores; special-function results (exp, log) a
# second are 1/16 of it.
FP32_SIMT_FLOPS = 67e12
SFU_OPS = FP32_SIMT_FLOPS / 16
HBM_BYTES_PER_S = 3.35e12
