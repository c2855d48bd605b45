"""Lane-scatter kernel: per-lane point updates ``x[l, idx[l]] (+)= val[l]``
over ``[L, N]`` state, in place (``csrc/lane_scatter.cu``).

This is the simulator's state write: every lane writes one element of its
own row, at a lane-varying index.  It replaces the Pallas kernel of the JAX
package's ``kernels/lane_scatter.py``, which copies each row and patches one
element; this one updates in place.  ``valid`` (bool ``[L]``) masks lanes
under lockstep execution: an invalid lane keeps its own bits.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import lane_scatter_add_ref, lane_scatter_set_ref

_DTYPES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}

# Kernel launches, one per wrapper call that launched on the card.
launches = {"lane_scatter": 0}


def _scatter(x, idx, val, valid, add: bool):
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be [L, N] f32/i32/bool, got "
                         f"{x.dtype}{list(x.shape)}")
    lanes, n = x.shape
    if idx.shape != (lanes,) or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int[{lanes}], got "
                         f"{idx.dtype}{list(idx.shape)}")
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    if val.dim() == 0:
        val = val.expand(lanes)
    if val.shape != (lanes,):
        raise ValueError(f"val must be [{lanes}], got {list(val.shape)}")
    if valid is not None and (valid.shape != (lanes,)
                              or valid.dtype != torch.bool):
        raise ValueError(f"valid must be bool[{lanes}]")
    devs = {t.device for t in (x, idx, val)} | (
        {valid.device} if valid is not None else set())
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = x.device
    if dev.type == "cpu":
        fn = lane_scatter_add_ref if add else lane_scatter_set_ref
        return fn(x, idx, val, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (it is updated in place)")
    idx = idx.to(torch.int32).contiguous()
    val = val.contiguous()
    valid_ptr = None if valid is None else valid.contiguous()
    with torch.cuda.device(dev):
        lib = _build.load("lane_scatter")
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.lane_scatter(
            x.data_ptr(), idx.data_ptr(), val.data_ptr(),
            None if valid_ptr is None else valid_ptr.data_ptr(),
            lanes, n, _DTYPES[x.dtype], int(add), stream), "lane_scatter")
    launches["lane_scatter"] += 1
    return x


def lane_scatter_set(x, idx, val, valid=None):
    """``x[l, idx[l]] = val[l]`` per (valid) lane, in place; returns x."""
    return _scatter(x, idx, val, valid, add=False)


def lane_scatter_add(x, idx, val, valid=None):
    """``x[l, idx[l]] += val[l]`` per (valid) lane, in place (logical OR
    for bool x); returns x."""
    return _scatter(x, idx, val, valid, add=True)
