"""Model FLOPs and bytes (6 N D-style MFU denominators; port of
``repro.launch.model_flops``).  Pure Python over the config."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig


def param_count(cfg: ArchConfig, active_only: bool = False) -> float:
    """Parameter count from the config (as ``transformer.init_params``
    allocates it)."""
    d, v = cfg.d_model, cfg.vocab_size
    n = 2 * d * v + d                      # embed + unembed + final norm
    per_layer = d                          # ln1
    if cfg.family in ("dense", "moe", "hybrid"):
        hd = cfg.head_dim
        per_layer += d * (cfg.num_heads * hd) * 2 \
            + d * (cfg.num_kv_heads * hd) * 2          # wq, wo, wk, wv
        per_layer += d                                   # ln2
    if cfg.family == "dense":
        mult = 3 if cfg.ffn_activation == "swiglu" else 2
        per_layer += mult * d * cfg.d_ff
    elif cfg.family == "moe":
        e = cfg.top_k if active_only else cfg.num_experts
        per_layer += d * cfg.num_experts                 # router (always)
        per_layer += 3 * d * cfg.moe_d_ff * e
        per_layer += 3 * d * cfg.moe_d_ff * cfg.num_shared_experts
    elif cfg.family in ("ssm", "hybrid"):
        di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * ns
        per_layer += d * di + d * conv_ch + d * h        # in_z/in_xbc/in_dt
        per_layer += cfg.ssm_conv_width * conv_ch + conv_ch
        per_layer += 3 * h + di + di * d                 # A/D/dtb, norm, out
        if cfg.family == "hybrid":
            per_layer += 2 * d                           # attn/ssm norms
            mult = 3 if cfg.ffn_activation == "swiglu" else 2
            per_layer += mult * d * cfg.d_ff
    return n + cfg.num_layers * per_layer


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs of one step, the MFU numerator.

    train: 6 N D (forward 2 N D, backward 4 N D); prefill: 2 N D; decode:
    2 N B (one token a sequence).  N leaves out the embedding lookup (a
    gather) and counts the active parameters of a moe model.
    """
    n_active = param_count(cfg, active_only=True) \
        - cfg.d_model * cfg.vocab_size
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch


def model_bytes_decode(cfg: ArchConfig, shape: ShapeConfig,
                       param_bytes: int = 2) -> float:
    """Least memory bytes of one decode step: the parameters and the KV
    or SSM state read once (the bandwidth roofline's numerator)."""
    n = param_count(cfg, active_only=True)
    b = shape.global_batch
    if cfg.family == "ssm":
        state = b * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        state += b * (cfg.ssm_conv_width - 1) * (cfg.d_inner
                                                 + 2 * cfg.ssm_state) * 2
        kv = cfg.num_layers * state
    elif cfg.family == "hybrid":
        kv = 0.0
        for i in range(cfg.num_layers):
            glob = i in (0, cfg.num_layers // 2, cfg.num_layers - 1)
            s = shape.seq_len if glob else min(cfg.sliding_window,
                                               shape.seq_len)
            kv += 2 * b * s * cfg.num_kv_heads * cfg.head_dim * param_bytes
            kv += b * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    else:
        kv = (2 * cfg.num_layers * b * shape.seq_len
              * cfg.num_kv_heads * cfg.head_dim * param_bytes)
    return n * param_bytes + kv
