"""Model/config schema + the assigned input-shape sets.

The same dataclasses and fields as the JAX package's ``configs/base.py``.
``torch_dtype``/``kv_torch_dtype`` take the place of its ``jdtype``/
``kv_jdtype``.  ``scan_layers``, ``gla_unroll`` and ``attn_unroll`` steer
how XLA lowers the JAX model; they are kept as data so that configs
compare field for field, and the port ignores them (its layers run in a
Python loop).  ``remat`` picks the training forward's recomputation
(:mod:`repro_torch.models.transformer`).
``use_kernel`` is ``True`` (the attention kernels, the default) or
``"ref"`` (their plain versions); the JAX default ``False`` selects an XLA
route the port does not have (see :mod:`repro_torch.models.attention`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    mlp_act: str = "swiglu"     # swiglu | geglu | gelu | relu2
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention details
    sliding_window: int = 0     # 0 = full causal attention
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_proj: float = 2.0       # d_inner / d_model (mamba branch / mLSTM up-proj)
    slstm_every: int = 0        # xLSTM: every k-th block is sLSTM (0 = none)
    # hybrid (Hymba)
    meta_tokens: int = 0
    # modality stubs (vlm / audio): inputs are precomputed embeddings
    frontend: str = "none"      # none | vision | audio
    out_heads: int = 1          # MusicGen: 4 codebook heads
    # training details
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # execution knobs (perf levers — see EXPERIMENTS.md §Perf)
    use_kernel: bool | str = True   # True | 'ref'
    remat: str = "full"         # full | dots | none
    scan_layers: bool = True
    gla_chunk: int = 256
    gla_unroll: bool = False    # unroll cross-chunk recurrence (dry-run)
    attn_unroll: bool = False   # unroll chunked-attention q loop (dry-run)
    kv_dtype: str = "bf16"      # 'bf16' | 'f8' (fp8_e4m3 KV cache; §Perf)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def kv_torch_dtype(self) -> torch.dtype:
        return (torch.float8_e4m3fn if self.kv_dtype == "f8"
                else self.torch_dtype)

    @property
    def is_recurrent(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (per-brief: ssm/hybrid only)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Total parameter count (exact, mirrors init)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            per_layer += d * h * dh + 2 * d * kv * dh + h * dh * d  # attn
            per_layer += 2 * d                                       # norms
            gated = self.mlp_act in ("swiglu", "geglu")
            ff = d * f * (3 if gated else 2)
            if self.family == "moe":
                per_layer += d * self.n_experts + self.n_experts * ff
            elif f > 0:
                per_layer += ff
        if self.family == "hybrid":
            di = int(d * self.ssm_proj)
            per_layer += (2 * d * di + 4 * di
                          + di * 2 * self.ssm_state * self.ssm_heads
                          + di * self.ssm_heads + 2 * self.ssm_heads
                          + di * d + 2)          # +2: b_attn, b_mamba
        if self.family == "ssm":
            di = int(d * self.ssm_proj)
            per_layer += (d * 2 * di + 4 * di + 3 * di * di
                          + di * 2 * self.n_heads + di + di * d + d)
        total = L * per_layer + v * d + d
        if not self.tie_embeddings:
            total += d * v * self.out_heads
        if self.meta_tokens:
            total += self.meta_tokens * d
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        gated = self.mlp_act in ("swiglu", "geglu")
        ff = d * f * (3 if gated else 2)
        inactive = self.n_layers * (self.n_experts - self.top_k) * ff
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


# The assigned LM shape set (applies to every architecture).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> Sequence[str]:
    """Applicable shapes: long_500k only for sub-quadratic archs (DESIGN.md §5)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
