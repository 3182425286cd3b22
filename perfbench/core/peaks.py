"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W
power limit): the rates PERF.md's kernel table divides by."""

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12      # CUDA cores, no TF32
BF16_FLOP_S = 989e12     # tensor cores
