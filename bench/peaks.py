"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12         # dense bf16 / fp16 tensor-core FLOP/s
INT8_OPS = 1979e12          # dense int8 tensor-core OP/s
HBM_BYTES_PER_S = 3.35e12   # HBM3 bandwidth
MFU_PEAK = BF16_FLOPS       # the peak every *mfu metric is a share of
