"""Architecture config schema + input-shape sets (port of
``repro.configs.base``).

Plain data, field for field and default for default as in the JAX
package, so that a config file reads the same in both packages.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # 'dense' | 'moe' | 'ssm' | 'hybrid'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim (d_ff if 0)
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4

    # --- attention details ---
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0         # chatglm3 2-D RoPE == 0.5
    sliding_window: int = 0         # 0 -> full attention
    global_attn_every: int = 0      # hybrid: which layers stay global

    # --- modality ---
    embedding_input: bool = False   # vlm/audio stub frontend (precomputed embeds)

    # --- capability flags ---
    subquadratic: bool = False      # may run long_500k

    # --- paper features ---
    pssa: bool = True               # self-attn score pruning + compression
    tips: bool = True               # sink-token mixed-precision FFN
    dbsc: bool = True               # bit-slice quantized FFN execution (serving)
    pssa_threshold: float = 1.0 / 8192.0
    tips_threshold: float = 0.05

    # --- training ---
    ffn_activation: str = "swiglu"
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- performance knobs ---
    tp_size: int = 16               # TP degree of the sharded JAX layout
    remat_save_collectives: bool = False  # save post-psum acts (no AR replay)
    kv_cache_dtype: str = "bfloat16"      # 'int8' halves decode KV traffic
    use_ssd_kernel: bool = False    # fused SSD scan kernel (serving/prefill path)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "moe" and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=512,
            head_dim=16,
        )
        if self.family == "moe":
            kw.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=64,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      moe_capacity_factor=8.0)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=8, ssm_head_dim=16)
        if self.sliding_window:
            kw.update(sliding_window=16)
        return self.scaled(name=self.name + "-smoke", **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # 'train' | 'prefill' | 'decode'


# The four LM shape sets of the JAX package.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}



def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (DESIGN.md §6)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
