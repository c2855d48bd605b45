"""Lane-scatter kernels: per-lane point updates ``x[l, idx[l]] (+)= val[l]``
over ``[L, N]`` state, in place (``csrc/lane_scatter.cu``).

This is the simulator's state write: every lane writes one element of its
own row, at a lane-varying index.  It replaces the Pallas kernel of the JAX
package's ``kernels/lane_scatter.py``, which copies each row and patches one
element; this one updates in place.  ``valid`` (bool ``[L]``) masks lanes
under lockstep execution: an invalid lane keeps its own bits.

- :func:`lane_scatter_set` / :func:`lane_scatter_add`: one write whose
  operands are tensors on x's device; one launch.
- :func:`lane_scatter_batch`: a list of writes whose operands are host
  arrays, in ONE launch: the descriptors, indices and values travel in the
  kernel's parameter block (:func:`pack`), so the batch costs no
  host-to-device copy.  A batch larger than one block goes out as
  consecutive launches on the same stream.

On a CUDA tensor a wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import (lane_host_vals, lane_scatter_add_ref,
                  lane_scatter_batch_ref, lane_scatter_set_ref)

_DTYPES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}

# Kernel launches, one per launch on the card.
launches = {"lane_scatter": 0}
# Calls of lane_scatter_batch on any device (a batch may take several
# launches on the card, and none on the CPU).
calls = {"lane_scatter_batch": 0}

# The parameter block of csrc/lane_scatter.cu, in int32 words.
HEAD_WORDS, TARGET_WORDS, WRITE_WORDS = 2, 8, 2
BLOCK_WORDS = 8190          # 32,760 bytes (CUDA >= 12.1 on sm_90)


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


# --- batched writes -----------------------------------------------------------
def _prepare(writes):
    """Checked host operands of each write, as ``(x, idx int32[R], vals,
    add)``: a row masked off by ``valid``, or indexed outside [0, N), gets
    index -1 (both routes skip it).  Returns ``(device, writes)``."""
    out, dev = [], None
    for x, idx, val, valid, add in writes:
        if x.dim() != 2 or x.dtype not in _DTYPES:
            raise ValueError(f"x must be [R, N] f32/i32/bool, got "
                             f"{x.dtype}{list(x.shape)}")
        rows, n = x.shape
        if n >= 2 ** 31:
            raise ValueError(f"N={n} does not fit an int32 index")
        idx = np.asarray(idx)
        if idx.shape != (rows,) or idx.dtype.kind not in "iu":
            raise ValueError(f"idx must be int[{rows}], got "
                             f"{idx.dtype}{list(idx.shape)}")
        # as uint64 a negative index is huge: one compare finds both ends
        skip = idx.astype(np.int64, copy=False).view(np.uint64) >= n
        if valid is not None:
            valid = np.asarray(valid)
            if valid.shape != (rows,) or valid.dtype != np.bool_:
                raise ValueError(f"valid must be bool[{rows}]")
            skip |= ~valid
        idx = np.where(skip, -1, idx).astype(np.int32)
        out.append((x, idx, lane_host_vals(x.dtype, val, rows), bool(add)))
        if dev is None:
            dev = x.device
        elif x.device != dev:
            raise ValueError(f"targets lie on several devices: "
                             f"{{{dev}, {x.device}}}")
    return dev, out


def _block(targets) -> np.ndarray:
    """One parameter block (layout in ``csrc/lane_scatter.cu``) from its
    targets ``[ptr, n, rows, dtype, nbytes, [(add, idx, vals)]]``."""
    nt = len(targets)
    head = [nt, 0]
    recs, body = [], []
    off = HEAD_WORDS + nt * TARGET_WORDS + WRITE_WORDS * sum(
        len(t[5]) for t in targets)
    row0 = w0 = 0
    for ptr, n, rows, dtype, _, ws in targets:
        head += [ptr & 0xffffffff, ptr >> 32, n, rows, row0, dtype, w0,
                 len(ws)]
        for add, idx, vals in ws:
            recs += [int(add), off]
            body += [idx, vals]
            off += 2 * rows
        row0 += rows
        w0 += len(ws)
    head[1] = row0
    # the pointer words are unsigned 32-bit: wrap them into int32
    return np.concatenate([np.array(head + recs, np.uint32).view(np.int32)]
                          + body)


def pack(writes, cap: int = BLOCK_WORDS) -> list[np.ndarray]:
    """The parameter blocks (int32 words) that apply prepared ``writes``
    (:func:`_prepare`) in list order, one launch each.

    A write too large for one block is cut by rows; a target whose memory
    overlaps another target of the block (a view of it) starts a new
    block, so no two threads of a launch alias."""
    blocks, targets, used = [], [], HEAD_WORDS
    step = (cap - HEAD_WORDS - TARGET_WORDS - WRITE_WORDS) // 2
    for x, idx, vals, add in writes:
        rows, n = x.shape
        dtype = _DTYPES[x.dtype]
        vals = vals.astype(np.int32) if dtype == 2 else vals.view(np.int32)
        row_bytes = n * x.element_size()
        base = x.data_ptr()
        for r0 in range(0, rows, step):
            r1 = min(rows, r0 + step)
            ptr, nb = base + r0 * row_bytes, (r1 - r0) * row_bytes
            key = [ptr, n, r1 - r0, dtype]
            t = None
            for u in targets:
                if u[:4] == key:
                    t = u
                    break
                if ptr < u[0] + u[4] and u[0] < ptr + nb:
                    t = False          # overlaps: a new block
                    break
            cost = WRITE_WORDS + 2 * (r1 - r0)
            if t is False or used + cost + (
                    TARGET_WORDS if t is None else 0) > cap:
                blocks.append(_block(targets))
                targets, used, t = [], HEAD_WORDS, None
            if t is None:
                t = key + [nb, []]
                targets.append(t)
                used += TARGET_WORDS
            t[5].append((add, idx[r0:r1], vals[r0:r1]))
            used += cost
    if targets:
        blocks.append(_block(targets))
    return blocks


def lane_scatter_batch(writes):
    """Apply ``writes`` in list order, in place, in one launch.

    Each write is ``(x [R, N], idx [R], val [R], valid [R] or None,
    add)``: ``x[r, idx[r]] = val[r]`` (``add``: ``+=``, a logical OR for
    bool x) for every row r where ``valid[r]`` (all rows when None).  x is
    a contiguous f32/i32/bool tensor; ``idx``, ``val`` and ``valid`` are
    host arrays (numpy or lists).  A later write to the same element wins;
    an index outside [0, N) is skipped.  On the card the whole list is one
    launch (consecutive launches on the same stream when it outgrows the
    parameter block); on the CPU it runs :func:`ref.lane_scatter_batch_ref`.
    """
    calls["lane_scatter_batch"] += 1
    dev, writes = _prepare(writes)
    if dev is None:
        return
    if dev.type == "cpu":
        lane_scatter_batch_ref([(x, i, v, None, a) for x, i, v, a in writes])
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for x, *_ in writes:
        if not x.is_contiguous():
            raise ValueError("x must be contiguous (it is updated in place)")
    blocks = pack(writes)
    lib = _build.load("lane_scatter")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b in blocks:
            _build.check(lib.lane_scatter_batch(b.ctypes.data, len(b),
                                                stream),
                         "lane_scatter_batch")
            launches["lane_scatter"] += 1
