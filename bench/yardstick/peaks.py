"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit)."""

BF16_FLOPS = 989.4e12          # dense bf16 tensor-core rate, FLOP/s
HBM_BYTES_PER_S = 3.35e12      # HBM3 bandwidth, bytes/s
