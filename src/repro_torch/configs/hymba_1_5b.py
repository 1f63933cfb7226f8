"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676].
(port of ``repro.configs.hymba_1_5b``).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (1024) everywhere except 3 global layers
(first/middle/last, per the Hymba paper) -> sub-quadratic, runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    sliding_window=1024,
    global_attn_every=16,    # layers 0, 16, 31 stay global (see
                             # transformer._is_global_layer)
    subquadratic=True,
)
