"""llama4-scout-17b-a16e [moe] — MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].
(port of ``repro.configs.llama4_scout_17b_a16e``).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 16e top-1 (+1 shared).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    num_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    rope_theta=500000.0,
)
