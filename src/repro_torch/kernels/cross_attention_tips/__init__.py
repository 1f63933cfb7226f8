from repro_torch.kernels.cross_attention_tips.ops import cross_attention_cas

__all__ = ["cross_attention_cas"]
