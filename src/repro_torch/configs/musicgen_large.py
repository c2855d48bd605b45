"""MusicGen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.
The EnCodec frontend is a STUB per the brief: input_specs() provides
precomputed frame embeddings (sum of the 4 codebook embeddings); the output
is 4 parallel codebook heads of vocab 2048 (delay interleaving pattern)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048,
    mlp_act="gelu", frontend="audio", out_heads=4,
    rope_theta=10_000.0,
)
