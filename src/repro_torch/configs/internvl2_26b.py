"""internvl2-26b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].
(port of ``repro.configs.internvl2_26b``).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
Backbone only; the InternViT frontend is a STUB — callers may pass
precomputed patch embeddings (``transformer.forward(embeds=)``;
DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    embedding_input=True,
)
