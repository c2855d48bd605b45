"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified].  The anyres vision tower is a STUB per the brief: input_specs()
provides precomputed patch embeddings concatenated with text embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    mlp_act="swiglu", rope_theta=1_000_000.0,
    frontend="vision",
)
