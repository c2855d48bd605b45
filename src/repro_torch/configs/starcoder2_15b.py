"""StarCoder2-15B [arXiv:2402.19173; hf] — GQA + RoPE + sliding window 4096,
plain-GELU MLP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    mlp_act="gelu", sliding_window=4096,
    rope_theta=100_000.0,
)
