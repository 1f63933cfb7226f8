"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]
(port of ``repro.configs.mamba2_130m``).

The published geometry: 24 layers, d_model 768, d_inner 1536, 24 SSM heads
of 64, state 128, conv width 4, vocab 50280, bfloat16.  Attention-free,
so PSSA and TIPS do not apply.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    subquadratic=True,
    pssa=False,
    tips=False,
)
