"""Eq.-16 ranking kernels: scores for the whole object table plus the masked
victim selection, in one pass over the inputs (``csrc/ranking_score.cu``).

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

TILE = 1024          # elements per CTA in the CUDA kernel

# Kernel launches, one per wrapper call that launched on the card.
launches = {"ranking_victim_order": 0, "ranking_scores": 0}


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
    """Scores [N] plus the merged ``top`` candidates (vals, idx)."""
    n = lam.shape[0]
    args = [x.contiguous() for x in (lam, z, resid, sizes, cached)]
    grid = -(-n // TILE)
    with torch.cuda.device(dev):
        lib = _build.load("ranking_score")
        stream = torch.cuda.current_stream(dev).cuda_stream
        scores = torch.empty(n, dtype=torch.float32, device=dev)
        cand_v = torch.empty(grid * top, dtype=torch.float32, device=dev)
        cand_i = torch.empty(grid * top, dtype=torch.int32, device=dev)
        vals = torch.empty(top, dtype=torch.float32, device=dev)
        idx = torch.empty(top, dtype=torch.int32, device=dev)
        _build.check(lib.rank_select_scores(
            *(a.data_ptr() for a in args), float(omega), n, top,
            scores.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), stream),
            "rank_select_scores")
        _build.check(lib.merge_candidates(
            cand_v.data_ptr(), cand_i.data_ptr(), grid * top, top,
            vals.data_ptr(), idx.data_ptr(), stream), "merge_candidates")
    return scores, idx, vals


def ranking_victim_order(lam, z, resid, sizes, cached, *, omega=1.0,
                         top: int = 8):
    """Eq.-16 scores and the masked ascending victim order.

    All inputs ``[N]`` (f32, ``cached`` bool); returns ``(scores f32[N],
    idx i32[top], vals f32[top])``: the ``top`` lowest-scored cached
    objects in ascending ``(score, index)`` order, continued by +inf
    sentinels (uncached objects, lowest index first) once the cache runs
    out.  Scores at or above 3.4e38 count as +inf.  ``top`` above the
    kernel's tile of 1024 raises (a tile could then hold more of the
    global order than it emits)."""
    n, dev = _check(lam, z, resid, sizes, cached)
    top = max(1, min(int(top), n))
    if top > TILE:
        raise ValueError(f"top={top} must be <= the tile, {TILE}")
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
