"""Hymba-1.5B [arXiv:2411.13676; hf] — parallel attention + Mamba heads in
every block, 128 meta tokens, sliding-window attention on most layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    mlp_act="swiglu",
    ssm_state=16, ssm_heads=25, ssm_proj=2.0,
    sliding_window=1024, meta_tokens=128,
    rope_theta=10_000.0,
)
