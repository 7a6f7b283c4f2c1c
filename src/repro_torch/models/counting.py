"""Analytic parameter counts (for roofline MODEL_FLOPS = 6*N*D cross-checks;
the port's copy of ``repro/models/counting.py``)."""
from __future__ import annotations


def _attn_params(cfg) -> int:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return d * H * hd + 2 * d * K * hd + H * hd * d


def _mlp_params(cfg) -> int:
    mult = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * cfg.d_ff


def _moe_params(cfg) -> int:
    return cfg.d_model * cfg.num_experts + cfg.num_experts * 3 * cfg.d_model * cfg.d_ff


def _moe_active(cfg) -> int:
    return cfg.d_model * cfg.num_experts \
        + cfg.num_experts_per_tok * 3 * cfg.d_model * cfg.d_ff


def _rwkv_layer(cfg) -> int:
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    tm = 5 * d + 4 * d * H * hd + 2 * H * hd + d * 64 + 64 * H * hd + H * hd * d
    cm = 2 * d + 2 * cfg.d_model * cfg.d_ff + d * d
    return tm + cm


def _mamba_layer(cfg) -> int:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds, dtr, cw = cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return (d * 2 * di + cw * di + di * dtr + dtr * di + di * 2 * ds
            + di * ds + di + di * d)


def _ffn_at(cfg, layer_idx: int) -> int:
    if cfg.num_experts and layer_idx % cfg.moe_every == cfg.moe_offset:
        return _moe_params(cfg)
    return _mlp_params(cfg)


def _ffn_active_at(cfg, layer_idx: int) -> int:
    if cfg.num_experts and layer_idx % cfg.moe_every == cfg.moe_offset:
        return _moe_active(cfg)
    return _mlp_params(cfg)


def count_params(cfg) -> int:
    return _count(cfg, active=False)


def count_active_params(cfg) -> int:
    return _count(cfg, active=True)


def _count(cfg, active: bool) -> int:
    ffn = _ffn_active_at if active else _ffn_at
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    total = emb + cfg.d_model  # final norm
    if cfg.family in ("dense", "moe", "vlm"):
        for l in range(cfg.num_layers):
            total += _attn_params(cfg) + ffn(cfg, l) + 2 * cfg.d_model
        if cfg.family == "vlm":
            total += cfg.d_model * cfg.d_model  # patch projection stub
    elif cfg.family == "ssm":
        total += cfg.num_layers * _rwkv_layer(cfg)
    elif cfg.family == "hybrid":
        for l in range(cfg.num_layers):
            in_group = l % cfg.hybrid_group
            mixer = _attn_params(cfg) if in_group == cfg.hybrid_attn_index \
                else _mamba_layer(cfg)
            total += mixer + ffn(cfg, l) + 2 * cfg.d_model
    elif cfg.family == "encdec":
        enc_layer = _attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model
        dec_layer = 2 * _attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff + 3 * cfg.d_model
        total += cfg.encoder_layers * enc_layer + cfg.num_layers * dec_layer
        total += cfg.encoder_d_model * cfg.d_model  # frame projection stub
    return total
