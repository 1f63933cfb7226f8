"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].
(port of ``repro.configs.musicgen_large``).

48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192 vocab=2048.
EnCodec frontend is a STUB — callers may pass precomputed frame
embeddings (``transformer.forward(embeds=)``).  MusicGen has true text
cross-attention, so TIPS applies in its original (CLS-token) form here
(DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="dense",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    embedding_input=True,
    ffn_activation="gelu",
)
