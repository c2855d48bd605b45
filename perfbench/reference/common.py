"""What every family's plain reference shares: float32 products with TF32
off, the float8 control's rounding, RMS norms, rotary positions, causal
attention in query blocks, and AdamW.  Plain PyTorch; it imports nothing
of the program.

``quant="fp8"`` is the control: both operands of every matrix product
are rounded to float8 e4m3 with one scale a tensor, the product summed
in float32; in training the rounding passes gradients straight through.
"""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def precise():
    """float32 products in float32: TF32 off while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    r = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (r - x).detach() if x.requires_grad else r


def qz(x, quant):
    """``x`` as a product's operand: rounded for the control."""
    return q8(x) if quant == "fp8" else x


def mm(a, b, quant=None):
    return qz(a, quant) @ qz(b, quant)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Half-split rotary embedding of ``x (S, n, dh)`` at ``pos (S,)``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: int, quant=None, block: int = 256):
    """Causal attention of ``q (S, H, dh)`` over ``k, v (S, KV, dh)`` at
    positions 0..S-1; a key is seen when it is at most the query's
    position and, under a window w, later than the position less w."""
    s, h, dh = q.shape
    kv = k.shape[1]
    qg = q.reshape(s, kv, h // kv, dh)
    pos = torch.arange(s, device=q.device)
    out = []
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        k0 = max(0, q0 - window + 1) if window else 0
        logits = torch.einsum("qkgd,skd->kgqs", qz(qg[q0:q1], quant),
                              qz(k[k0:q1], quant)) * dh ** -0.5
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        keep = kp <= qp
        if window:
            keep &= kp > qp - window
        logits = logits.masked_fill(~keep, float("-inf"))
        p = torch.softmax(logits, dim=-1)
        out.append(torch.einsum("kgqs,skd->qkgd", qz(p, quant),
                                qz(v[k0:q1], quant)).reshape(q1 - q0, h, dh))
    return torch.cat(out)


def cross_entropy(logits, labels):
    """Mean negative log-likelihood of ``labels (S,)`` under ``logits
    (S, V)``."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - picked).mean()


def decays(path: str, leaf: torch.Tensor) -> bool:
    """The program's weight-decay rule: a block's leaf decays when it has
    an axis (its rank counts the stacked layer axis of the model it was
    ported from), an outer leaf when it has two."""
    rank = leaf.dim() + (1 if path.startswith("layers.") else 0)
    return rank > 1


def schedule(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of the peak."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


@torch.no_grad()
def adamw(leaves: list, grads: list, m: list, v: list, decay: list,
          opt: dict, step: int) -> list:
    """One AdamW step in float32 on ``leaves`` in place, the gradients
    clipped to ``clip_norm`` by their global norm first; returns the
    clipped gradients."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    clipped = []
    for p, g, mi, vi, dec in zip(leaves, grads, m, v, decay):
        g = g * scale
        clipped.append(g)
        mi.mul_(b1).add_(g * (1 - b1))
        vi.mul_(b2).add_(g * g * (1 - b2))
        u = (mi / (1 - b1 ** step)) / (torch.sqrt(vi / (1 - b2 ** step))
                                       + opt["eps"])
        if dec and opt["weight_decay"]:
            u = u + p * opt["weight_decay"]
        p.sub_(lr * u)
    return clipped
