"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].
(port of ``repro.configs.qwen2_moe_a2_7b``).

24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936, 60e top-4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
)
