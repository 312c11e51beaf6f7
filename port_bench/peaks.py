"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity), at its 700 W power limit."""

PEAK_BF16 = 989e12     # FLOP/s, bf16 / fp16 tensor cores
PEAK_FP32 = 67e12      # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12   # B/s, HBM3
