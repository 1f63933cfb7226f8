from repro_torch.kernels.bitslice_matmul.ops import bitslice_matmul
from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_ref

__all__ = ["bitslice_matmul", "bitslice_matmul_ref"]
