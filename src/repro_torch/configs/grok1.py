"""Grok-1 314B MoE [hf:xai-org/grok-1; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, mlp_act="geglu",
    logit_softcap=30.0,          # grok's attn-logit soft cap
    rope_theta=10_000.0,
)
