"""Eq.-16 ranking kernels: scores for the whole object table plus the masked
victim selection, in one pass over the inputs and one launch
(``csrc/ranking_score.cu``).

``ranking_victim_order`` returns the scores and the ``top`` lowest-ranked
cached objects in ascending ``(score, index)`` order; ``ranking_scores``
returns the scores and the single masked argmin.  Both replace the Pallas
kernels of the JAX package's ``kernels/ranking_score.py``.  The source
note in the ``.cu`` file says what bounds them on the card.

On a CUDA tensor a wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain version in :mod:`repro_torch.kernels.ref`, which computes
the same bits.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ranking_scores_ref, ranking_victim_order_ref

TILE = 4096          # elements per CTA in the CUDA kernel
MAX_TOP = 1024       # the longest victim order the kernel emits

# Kernel launches, one per wrapper call that launched on the card.
launches = {"ranking_victim_order": 0, "ranking_scores": 0}

# The cross-tile merge tickets, one int by (device, stream): zero between
# launches (the last CTA of a launch sets it back to 0).
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _check(lam, z, resid, sizes, cached):
    n = lam.shape[0]
    for name, x in (("lam", lam), ("z", z), ("resid", resid),
                    ("sizes", sizes)):
        if x.dtype != torch.float32 or x.shape != (n,):
            raise ValueError(f"{name} must be f32[{n}], got "
                             f"{x.dtype}{list(x.shape)}")
    if cached.dtype != torch.bool or cached.shape != (n,):
        raise ValueError(f"cached must be bool[{n}], got "
                         f"{cached.dtype}{list(cached.shape)}")
    devs = {x.device for x in (lam, z, resid, sizes, cached)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    return n, devs.pop()


def _launch(lam, z, resid, sizes, cached, omega, top, dev):
    """Scores [N] plus the ``top`` least masked keys (idx, vals), from one
    launch."""
    n = lam.shape[0]
    args = [x.contiguous() for x in (lam, z, resid, sizes, cached)]
    with torch.cuda.device(dev):
        lib = _build.load("ranking_score")
        stream = torch.cuda.current_stream(dev).cuda_stream
        ticket = _tickets.get((dev.index, stream))
        if ticket is None:
            ticket = _tickets[(dev.index, stream)] = torch.zeros(
                1, dtype=torch.int32, device=dev)
        scores = torch.empty(n, dtype=torch.float32, device=dev)
        # merge scratch: 2 * max(top, 8) keys (of two int32) a tile bound
        # every merge level of either selection path
        cand = torch.empty(4 * max(top, 8) * -(-n // TILE),
                           dtype=torch.int32, device=dev)
        vals = torch.empty(top, dtype=torch.float32, device=dev)
        idx = torch.empty(top, dtype=torch.int32, device=dev)
        _build.check(lib.rank_select(
            *(a.data_ptr() for a in args), float(omega), n, top,
            scores.data_ptr(), cand.data_ptr(), ticket.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), stream), "rank_select")
    return scores, idx, vals


def ranking_victim_order(lam, z, resid, sizes, cached, *, omega=1.0,
                         top: int = 8):
    """Eq.-16 scores and the masked ascending victim order.

    All inputs ``[N]`` (f32, ``cached`` bool); returns ``(scores f32[N],
    idx i32[top], vals f32[top])``: the ``top`` lowest-scored cached
    objects in ascending ``(score, index)`` order, continued by +inf
    sentinels (uncached objects, lowest index first) once the cache runs
    out.  Scores at or above 3.4e38 count as +inf.  ``top`` above
    :data:`MAX_TOP` (1024) raises."""
    n, dev = _check(lam, z, resid, sizes, cached)
    top = max(1, min(int(top), n))
    if top > MAX_TOP:
        raise ValueError(f"top={top} must be <= {MAX_TOP}")
    if dev.type == "cpu":
        return ranking_victim_order_ref(lam, z, resid, sizes, cached,
                                        omega, top)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _launch(lam, z, resid, sizes, cached, omega, top, dev)
    launches["ranking_victim_order"] += 1
    return out


def ranking_scores(lam, z, resid, sizes, cached, *, omega=1.0):
    """Eq.-16 scores plus the masked argmin victim: ``(scores f32[N],
    victim_idx i32, victim_score f32)`` (first index on ties; +inf when
    nothing is cached)."""
    n, dev = _check(lam, z, resid, sizes, cached)
    if dev.type == "cpu":
        return ranking_scores_ref(lam, z, resid, sizes, cached, omega)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    scores, idx, vals = _launch(lam, z, resid, sizes, cached, omega, 1, dev)
    launches["ranking_scores"] += 1
    return scores, idx[0], vals[0]
