"""Decoder model for every family of the JAX package's
``models/transformer.py``:

  dense / vlm / audio - pre-norm attention + MLP blocks (vlm/audio take
      precomputed frontend embeddings, ``embeds``, and ``out_heads > 1``
      (MusicGen) splits the LM head into parallel codebook heads);
  moe    - attention + top-k MoE blocks (:mod:`repro_torch.models.moe`);
  ssm    - xLSTM mLSTM blocks (self-contained mixers, d_ff = 0);
  hybrid - Hymba: parallel attention + Mamba heads per block, mixed as
      ``x + b_attn * attn + b_mamba * mamba``, and meta tokens prepended
      to every prompt.

Three modes share one code path:

  train   - full sequence, logits at every position; the loss
            (:func:`loss_fn`) and its gradients run through it;
  prefill - full sequence, last-token logits + the serving cache;
  decode  - one token + cache (KV ring buffer and recurrent state), at
            absolute ``pos0`` (which counts the meta tokens).

Parameters are plain dicts; ``params["layers"]`` is a list of per-layer
dicts, walked by a Python loop (the JAX model's ``lax.scan`` has no
counterpart).  :func:`abstract_params` is the tree on the ``meta`` device.
The JAX model's sharding hints are kept: ``constrain`` at the residual
stream and the logits (:mod:`repro_torch.sharding.activation`), the
identity unless a launcher installs rules and the tensors are DTensors.
In train mode with autograd on,
``cfg.remat == "full"`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` with
``nothing_saveable`` does; ``"dots"`` (the JAX policy that keeps the
products and recomputes the elementwise ops) keeps every activation here,
as ``"none"`` does.  The cache is a list of per-layer dicts: its KV
tensors are updated in place, its recurrent state is replaced by each
call's result.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..sharding.activation import constrain
from .attention import attn_apply, init_attn, init_kv_cache
from .layers import (init_dense, init_embed, mlp_apply, mlp_init, rms_norm,
                     split_heads)
from .moe import init_moe, moe_apply
from .ssm import (init_gla_state, init_mamba, init_mlstm, mamba_apply,
                  mlstm_apply)

FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); the "
                         f"model has {FAMILIES}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(g: torch.Generator, cfg: ModelConfig) -> dict:
    dt, d = cfg.torch_dtype, cfg.d_model
    p = {"ln1": torch.ones((d,), dtype=dt, device=g.device)}
    if cfg.family == "ssm":
        p["mlstm"] = init_mlstm(g, d, cfg.n_heads, cfg.ssm_proj, dtype=dt)
        return p
    p["attn"] = init_attn(g, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, dt)
    p["ln2"] = torch.ones((d,), dtype=dt, device=g.device)
    if cfg.family == "moe":
        p["moe"] = init_moe(g, d, cfg.d_ff, cfg.n_experts, cfg.mlp_act, dt)
    else:
        p["mlp"] = mlp_init(g, d, cfg.d_ff, cfg.mlp_act, dt)
    if cfg.family == "hybrid":
        p["mamba"] = init_mamba(g, d, int(d * cfg.ssm_proj), cfg.ssm_heads,
                                cfg.ssm_state, dtype=dt)
        p["b_attn"] = torch.ones((), dtype=torch.float32, device=g.device)
        p["b_mamba"] = torch.ones((), dtype=torch.float32, device=g.device)
    return p


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


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of :func:`init_params` on the ``meta`` device, at
    the same shapes and dtypes, with no allocation (the dry-run path)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..training.optimizer import tree_map
    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg)
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), fake)


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
    """Serving cache sized for ``capacity`` total positions (incl. meta),
    one dict per layer on ``device`` (None: the card): a ring-buffer KV
    cache under ``"attn"`` (not for ``ssm``) and, for ``ssm``/``hybrid``,
    the f32 recurrent state and the conv tail under ``"ssm"``."""
    check_family(cfg)
    dev = resolve_device(device)
    sc = capacity
    if cfg.sliding_window:
        sc = min(capacity, cfg.meta_tokens + cfg.sliding_window)
    di = int(cfg.d_model * cfg.ssm_proj)
    gla = None                  # (heads, dk, dv) of the recurrent state
    if cfg.family == "ssm":
        gla = (cfg.n_heads, di // cfg.n_heads, di // cfg.n_heads)
    elif cfg.family == "hybrid":
        gla = (cfg.ssm_heads, cfg.ssm_state, di // cfg.ssm_heads)

    def per_layer():
        c = {}
        if cfg.family != "ssm":
            c["attn"] = init_kv_cache(batch, sc, cfg.n_kv_heads, cfg.d_head,
                                      cfg.kv_torch_dtype, dev)
        if gla is not None:
            s, n = init_gla_state(batch, *gla, dev)
            c["ssm"] = {"S": s, "n": n,
                        "conv": torch.zeros((batch, 3, di),
                                            dtype=cfg.torch_dtype,
                                            device=dev)}
        return c

    return [per_layer() for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------
def _recurrent(cache: dict | None, mode: str):
    """The carried (state, conv tail) of a recurrent mixer: only in decode,
    as the JAX model does (a prefill starts from zeros)."""
    if cache is None or mode != "decode":
        return None, None
    return (cache["ssm"]["S"], cache["ssm"]["n"]), cache["ssm"]["conv"]


def _block(cfg: ModelConfig, p: dict, x, pos, cache: dict | None,
           mode: str):
    """One block: (x, new cache or None, the MoE layer's f32 aux loss or
    None for the other families)."""
    aux = None
    h = rms_norm(x, p["ln1"])
    new_cache = None if cache is None else {}
    if cfg.family == "ssm":
        state, tail = _recurrent(cache, mode)
        out, (state, tail) = mlstm_apply(
            p["mlstm"], h, n_heads=cfg.n_heads, state=state, conv_tail=tail,
            chunk=cfg.gla_chunk, use_kernel=cfg.use_kernel)
        if cache is not None:
            new_cache["ssm"] = {"S": state[0], "n": state[1], "conv": tail}
        return x + out, new_cache, aux

    attn_out, attn_cache = attn_apply(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.d_head, pos=pos, theta=cfg.rope_theta,
        window=cfg.sliding_window, softcap=cfg.logit_softcap,
        sink=cfg.meta_tokens,
        cache=None if cache is None else cache["attn"],
        use_kernel=cfg.use_kernel)
    if cache is not None:
        new_cache["attn"] = attn_cache
    if cfg.family == "hybrid":
        state, tail = _recurrent(cache, mode)
        m_out, (state, tail) = mamba_apply(
            p["mamba"], h, n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
            state=state, conv_tail=tail, chunk=cfg.gla_chunk,
            use_kernel=cfg.use_kernel)
        x = (x + p["b_attn"].to(x.dtype) * attn_out
             + p["b_mamba"].to(x.dtype) * m_out)
        if cache is not None:
            new_cache["ssm"] = {"S": state[0], "n": state[1], "conv": tail}
    else:
        x = x + attn_out
    x = constrain(x, "residual")
    h2 = rms_norm(x, p["ln2"])
    if cfg.family == "moe":
        mlp_out, aux = moe_apply(p["moe"], h2, top_k=cfg.top_k,
                                 act=cfg.mlp_act,
                                 capacity_factor=cfg.capacity_factor)
    else:
        mlp_out = mlp_apply(p["mlp"], h2, cfg.mlp_act)
    return constrain(x + mlp_out, "residual"), new_cache, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def forward(params: dict, cfg: ModelConfig, *, tokens=None, embeds=None,
            cache=None, pos0: int = 0, mode: str = "train"):
    """Returns (logits, cache, aux_loss).

    tokens (B,S) integer ids or embeds (B,S,d) (vlm/audio stubs), on the
    parameters' device; decode: S == 1 and ``pos0`` (an int or a 0-d
    integer tensor on that device) is the absolute
    position of the incoming token, including the meta-token offset for
    hybrid archs.  The aux loss is the f32 sum of the MoE layers'
    load-balance losses (0 for the other families).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    check_family(cfg)
    emb = params["embed"]
    if embeds is None and hasattr(emb, "device_mesh"):
        # a DTensor table is gathered whole for the lookup (its gradient is
        # reduced back to the table's split), which DTensor shards by the
        # tokens' batch rows
        from torch.distributed.tensor import Replicate
        emb = emb.redistribute(emb.device_mesh,
                               [Replicate()] * emb.device_mesh.ndim)
    x = (torch.nn.functional.embedding(tokens, emb) if embeds is None
         else embeds.to(cfg.torch_dtype))
    b, s = x.shape[0], x.shape[1]
    m = cfg.meta_tokens
    if m and mode != "decode":
        meta = params["meta"].to(x.dtype).expand(b, m, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        s = s + m
    x = constrain(x, "residual")

    # a fill on the device, not a copy from the host: no stream sync
    if mode != "decode":
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
    elif isinstance(pos0, torch.Tensor):   # a 0-d tensor: no host read
        pos = pos0.to(torch.int32).reshape(1)
    else:
        pos = torch.full((1,), int(pos0), dtype=torch.int32, device=x.device)
    remat = (mode == "train" and cache is None and cfg.remat == "full"
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None if cache is None else []
    for li, p_l in enumerate(params["layers"]):
        c_l = None if cache is None else cache[li]
        if remat:
            x, c, a = checkpoint(_block, cfg, p_l, x, pos, None, mode,
                                 use_reentrant=False)
        else:
            x, c, a = _block(cfg, p_l, x, pos, c_l, mode)
        if a is not None:
            aux = aux + a
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
        logits = split_heads(logits, cfg.out_heads, cfg.vocab)
    logits = constrain(logits, "logits")
    return logits, new_cache, aux


# ---------------------------------------------------------------------------
# Losses (model-level; the train step lives in training/)
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -100) -> torch.Tensor:
    """Mean f32 negative log-likelihood over the labels that are not
    ``ignore``; (B,S,V) logits with (B,S) labels or (B,S,K,V) with
    (B,S,K).  The label's logit is a masked sum over the vocab, which
    picks the same value as the JAX function's one-hot contraction."""
    lf = logits.float()
    # logsumexp as ATen forms it (max, sum of exp, log, add), in ops that a
    # vocab-sharded DTensor reduces shard by shard
    mx = torch.amax(lf, dim=-1, keepdim=True)
    mx = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
    lse = torch.log(torch.sum(torch.exp(lf - mx), dim=-1)) + mx[..., 0]
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    # the label's logit as a masked sum over the vocab, as the JAX
    # function's one-hot contraction: on a vocab-sharded DTensor it reduces
    # locally, and its gradient keeps the logits' sharding
    hit = safe[..., None] == torch.arange(lf.shape[-1], device=lf.device)
    if hasattr(lf, "device_mesh"):     # a DTensor: the mask split like lf
        hit = hit.redistribute(lf.device_mesh, lf.placements)
    picked = (lf * hit).sum(-1)
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def loss_fn(params, cfg: ModelConfig, batch: dict,
            aux_coef: float = 0.01):
    """(loss, {"ce", "aux"}): ``ce + aux_coef * aux`` on a batch of
    ``tokens`` or ``embeds`` and ``labels``; (B,S) labels are broadcast
    over MusicGen's codebook heads."""
    logits, _, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        mode="train")
    labels = batch["labels"]
    if cfg.out_heads > 1 and labels.dim() == 2:
        labels = labels[..., None].expand(*labels.shape, cfg.out_heads)
    ce = cross_entropy(logits, labels)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}
