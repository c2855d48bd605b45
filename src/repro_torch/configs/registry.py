"""Architecture registry: the 10 assigned configs + reduced smoke variants."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig

from .phi35_moe import CONFIG as phi35_moe
from .grok1 import CONFIG as grok1
from .starcoder2_15b import CONFIG as starcoder2_15b
from .deepseek_coder_33b import CONFIG as deepseek_coder_33b
from .minitron_8b import CONFIG as minitron_8b
from .stablelm_1_6b import CONFIG as stablelm_1_6b
from .xlstm_350m import CONFIG as xlstm_350m
from .llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from .hymba_1_5b import CONFIG as hymba_1_5b
from .musicgen_large import CONFIG as musicgen_large

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    phi35_moe, grok1, starcoder2_15b, deepseek_coder_33b, minitron_8b,
    stablelm_1_6b, xlstm_350m, llava_next_mistral_7b, hymba_1_5b,
    musicgen_large,
]}


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def smoke(name: str) -> ModelConfig:
    """Reduced same-family config: tiny layers/width/experts/vocab, runnable
    on CPU in a unit test. The FULL configs are exercised only via the
    dry-run (ShapeDtypeStruct, no allocation)."""
    c = ARCHS[name]
    d = 64
    heads = max(2, min(4, c.n_heads))
    kv = heads if c.n_kv_heads >= c.n_heads else max(1, heads // 2)
    return dataclasses.replace(
        c,
        name=c.name + "-smoke",
        n_layers=2,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=d // heads,
        d_ff=0 if c.d_ff == 0 else 128,
        vocab=256,
        n_experts=min(c.n_experts, 4) if c.n_experts else 0,
        top_k=min(c.top_k, 2) if c.top_k else 0,
        # lossless capacity so prefill+decode == full forward exactly
        capacity_factor=8.0,
        sliding_window=min(c.sliding_window, 32) if c.sliding_window else 0,
        ssm_state=min(c.ssm_state, 8) if c.ssm_state else 0,
        ssm_heads=min(c.ssm_heads, 2) if c.ssm_heads else 0,
        meta_tokens=min(c.meta_tokens, 8) if c.meta_tokens else 0,
        gla_chunk=16,
    )
