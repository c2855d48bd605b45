"""Decoder model for the dense-block families (``dense``, ``vlm``, ``audio``).

The counterpart of the JAX package's ``models/transformer.py``: pre-norm
attention + MLP blocks; vlm/audio take precomputed frontend embeddings
(``embeds``) in place of tokens, and ``out_heads > 1`` (MusicGen) splits
the LM head into parallel codebook heads.  Three modes share one code path:

  train   - full sequence, logits at every position (no backward yet);
  prefill - full sequence, last-token logits + the serving cache;
  decode  - one token + cache (KV ring buffer), at absolute ``pos0``.

Parameters are plain dicts; ``params["layers"]`` is a list of per-layer
dicts, walked by a Python loop (the JAX model's ``lax.scan``, ``remat`` and
sharding hints have no counterpart on one card).  The cache is a list of
per-layer dicts, updated in place.  The ``moe``, ``ssm`` and ``hybrid``
families are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from .attention import attn_apply, init_attn, init_kv_cache
from .layers import init_dense, init_embed, mlp_apply, mlp_init, rms_norm

DENSE_FAMILIES = ("dense", "vlm", "audio")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in DENSE_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            f"has the dense-block families {DENSE_FAMILIES}; MoE and the "
            f"xLSTM/Hymba mixers are ROADMAP queue 1, item 11")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(g: torch.Generator, cfg: ModelConfig) -> dict:
    dt, d = cfg.torch_dtype, cfg.d_model
    return {
        "ln1": torch.ones((d,), dtype=dt, device=g.device),
        "attn": init_attn(g, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, dt),
        "ln2": torch.ones((d,), dtype=dt, device=g.device),
        "mlp": mlp_init(g, d, cfg.d_ff, cfg.mlp_act, dt),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on the generator's device, with the JAX init's laws
    (``models/layers.py``) but not its numbers."""
    check_family(cfg)
    g, dt = generator, cfg.torch_dtype
    params = {
        "embed": init_embed(g, cfg.vocab, cfg.d_model, dt),
        "layers": [_init_layer(g, cfg) for _ in range(cfg.n_layers)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=g.device),
        "lm_head": init_dense(g, cfg.d_model, cfg.vocab * cfg.out_heads, dt),
    }
    if cfg.meta_tokens:
        params["meta"] = (torch.randn(
            (cfg.meta_tokens, cfg.d_model), generator=g, device=g.device)
            * 0.02).to(dt)
    return params


def n_params(params: dict) -> int:
    n = 0
    for v in params.values():
        if isinstance(v, torch.Tensor):
            n += v.numel()
        elif isinstance(v, dict):
            n += n_params(v)
        else:
            n += sum(n_params(layer) for layer in v)
    return n


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> list:
    """Serving cache sized for ``capacity`` total positions (incl. meta):
    one ring-buffer KV dict per layer, on ``device`` (None: the card)."""
    check_family(cfg)
    dev = resolve_device(device)
    sc = capacity
    if cfg.sliding_window:
        sc = min(capacity, cfg.meta_tokens + cfg.sliding_window)
    return [{"attn": init_kv_cache(batch, sc, cfg.n_kv_heads, cfg.d_head,
                                   cfg.kv_torch_dtype, dev)}
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------
def _block(cfg: ModelConfig, p: dict, x, pos, cache: dict | None):
    h = rms_norm(x, p["ln1"])
    attn_out, attn_cache = attn_apply(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.d_head, pos=pos, theta=cfg.rope_theta,
        window=cfg.sliding_window, softcap=cfg.logit_softcap,
        sink=cfg.meta_tokens,
        cache=None if cache is None else cache["attn"],
        use_kernel=cfg.use_kernel)
    x = x + attn_out
    x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"]), cfg.mlp_act)
    return x, (None if cache is None else {"attn": attn_cache})


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def forward(params: dict, cfg: ModelConfig, *, tokens=None, embeds=None,
            cache=None, pos0: int = 0, mode: str = "train"):
    """Returns (logits, cache, aux_loss).

    tokens (B,S) integer ids or embeds (B,S,d) (vlm/audio stubs), on the
    parameters' device; decode: S == 1 and ``pos0`` is the absolute
    position of the incoming token.  The aux loss is 0 (no MoE here).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    check_family(cfg)
    emb = params["embed"]
    x = emb[tokens] if embeds is None else embeds.to(cfg.torch_dtype)
    b, s = x.shape[0], x.shape[1]
    m = cfg.meta_tokens
    if m and mode != "decode":
        meta = params["meta"].to(x.dtype).expand(b, m, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        s = s + m

    # a fill on the device, not a copy from the host: no stream sync
    pos = (torch.full((1,), int(pos0), dtype=torch.int32, device=x.device)
           if mode == "decode"
           else torch.arange(s, dtype=torch.int32, device=x.device))
    new_cache = None if cache is None else []
    for li, p_l in enumerate(params["layers"]):
        x, c = _block(cfg, p_l, x, pos, None if cache is None else cache[li])
        if cache is not None:
            new_cache.append(c)

    x = rms_norm(x, params["final_norm"])
    if mode == "train":
        if m:
            x = x[:, m:]
    elif mode == "prefill":
        x = x[:, -1:]
    logits = x @ params["lm_head"]
    if cfg.out_heads > 1:
        logits = logits.reshape(*logits.shape[:-1], cfg.out_heads, cfg.vocab)
    return logits, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)
