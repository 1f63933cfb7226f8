"""PyTorch/CUDA port of the SD-processor reproduction (``repro``).

Mirrors the JAX package's layout.  Entry points run on the card unless the
caller passes ``device="cpu"``; the PSSA attention, TIPS cross-attention
and DBSC bit-slice matmul run as hand-written CUDA kernels (``csrc/``) on
CUDA tensors and as their plain PyTorch versions on CPU tensors.
"""
