from repro_torch.kernels.pssa_attention.ops import pssa_attention
from repro_torch.kernels.pssa_attention.ref import pssa_attention_ref

__all__ = ["pssa_attention", "pssa_attention_ref"]
