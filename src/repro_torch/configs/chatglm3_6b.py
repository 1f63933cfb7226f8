"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2 [arXiv:2406.12793].
(port of ``repro.configs.chatglm3_6b``).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rotary_pct=0.5,          # 2-D RoPE: rotate half of each head dim
)
