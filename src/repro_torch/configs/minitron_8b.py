"""Minitron-8B [arXiv:2407.14679; hf] — pruned Nemotron; squared-ReLU MLP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000,
    mlp_act="relu2", rope_theta=10_000.0,
)
