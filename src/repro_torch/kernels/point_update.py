"""The replay engine's point update on the card (``csrc/point_update.cu``):
one launch serves a request, or commits a fetch, at one object per lane of
the ``[12, L, N]`` f32 / ``[2, L, N]`` bool state, in place.

It replaces the engine's per-request round trip (read every field at the
object back, compute the new values on the host, write them with a
lane-scatter launch) by the arithmetic itself on the card, so a serve or a
non-scoring commit reads nothing back.  The commit's three statistics
(``agg_sum``, ``agg_sq_sum``, ``agg_cnt``) are adds on the card, as the
JAX reference's ``lane_add`` (the add half of its ``lane_scatter``
kernel) makes them.

:class:`PointUpdate` holds one engine's state, its lanes' constants and a
host parameter block that it refills at every call: the indices, times
and clocks travel in the kernel's parameters, so a launch needs no copy.
On a CUDA state it launches the kernel (or raises); on a CPU state, or
with ``plain=True`` on any device, it runs the plain versions
:func:`repro_torch.kernels.ref.point_serve_ref` /
:func:`~repro_torch.kernels.ref.point_commit_ref`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .ref import point_commit_ref, point_serve_ref

# Kernel launches, one per launch on the card.
launches = {"point_update": 0}

# The parameter block of csrc/point_update.cu, in int32 words: a header,
# then one record a lane.
HEAD_WORDS, LANE_WORDS = 20, 8
BLOCK_WORDS = (128, 1024, 8190)     # the kernel's three block sizes
MAX_LANES = (BLOCK_WORDS[-1] - HEAD_WORDS) // LANE_WORDS
# lane record flags
ACTIVE, GD, GD_RATE = 1, 2, 4


class _Block(NamedTuple):
    """One launch's parameter block: its words (int32 and f32 views), its
    lane records (the same), the engine's lanes it covers, their flags
    without and with ACTIVE, and the words' host address."""

    w: np.ndarray
    wf: np.ndarray
    rec: np.ndarray
    rec_f: np.ndarray
    sl: slice
    base: np.ndarray
    on: np.ndarray
    addr: int


def _ptr(words, at: int, ptr: int) -> None:
    """A device pointer into two words (low, high)."""
    words[at:at + 2] = np.array([ptr & 0xffffffff, ptr >> 32],
                                np.uint32).view(np.int32)


class PointUpdate:
    """The point updates of one engine's state.

    ``values`` f32 [12, L, N] and ``flags`` bool [2, L, N] (contiguous, on
    one device); ``gd``, ``gd_rate`` (bool [L]), ``cold_rate``,
    ``gap_alpha`` (f32 [L]) the lanes' policy constants; ``eps`` the
    estimators' floor; ``table`` a slot engine's ``(key_tab, sizes)``,
    which a first touch writes.  ``plain`` runs the plain versions on any
    device."""

    def __init__(self, values, flags, gd, gd_rate, cold_rate, gap_alpha,
                 eps: float, estimate_z: bool, plain: bool = False,
                 table=None):
        self.values, self.flags, self.table = values, flags, table
        self.dev = values.device
        self.L, self.N = values.shape[1], values.shape[2]
        self.estimate_z = bool(estimate_z)
        self.kernel = self.dev.type == "cuda" and not plain
        if self.dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.dev}")
        f32 = lambda x: np.broadcast_to(np.asarray(x, np.float32),
                                        (self.L,))
        lane_t = lambda x, dt: torch.as_tensor(np.array(x), dtype=dt,
                                               device=self.dev)
        self.lane = (lane_t(gd, torch.bool), lane_t(gd_rate, torch.bool),
                     lane_t(f32(cold_rate), torch.float32),
                     lane_t(f32(gap_alpha), torch.float32),
                     float(np.float32(eps)))
        if not self.kernel:
            return
        for x in (values, flags) + (tuple(table) if table else ()):
            if not x.is_contiguous():
                raise ValueError("the state must be contiguous (it is "
                                 "updated in place)")
        if values.dtype != torch.float32 or flags.dtype != torch.bool:
            raise ValueError("values must be f32 and flags bool")
        # one block a launch, lanes [k * MAX_LANES, ...) in launch k: its
        # words as int32 and f32 views, its lane records as [n, 8] views
        self._blocks = []
        for l0 in range(0, self.L, MAX_LANES):
            n = min(MAX_LANES, self.L - l0)
            w = np.zeros(HEAD_WORDS + LANE_WORDS * n, np.int32)
            w[0], w[1], w[2], w[3] = n, l0, self.L, self.N
            _ptr(w, 4, values.data_ptr())
            _ptr(w, 6, flags.data_ptr())
            if table is not None:
                _ptr(w, 8, table[0].data_ptr())
                _ptr(w, 10, table[1].data_ptr())
            wf = w.view(np.float32)
            wf[16] = eps
            rec = w[HEAD_WORDS:].reshape(n, LANE_WORDS)
            rec_f = rec.view(np.float32)
            sl = slice(l0, l0 + n)
            rec_f[:, 5] = f32(cold_rate)[sl]
            rec_f[:, 6] = f32(gap_alpha)[sl]
            base = (GD * np.asarray(gd, bool)[sl]
                    | GD_RATE * np.asarray(gd_rate, bool)[sl]).astype(
                        np.int32)
            self._blocks.append(_Block(w, wf, rec, rec_f, sl, base,
                                       base | ACTIVE, w.ctypes.data))
        self._fns = None            # the C entry points, at first launch

    # --- the plain route --------------------------------------------------
    def _t(self, x, dtype):
        a = np.array(np.broadcast_to(np.asarray(x), (self.L,)))
        return torch.as_tensor(a, dtype=dtype, device=self.dev)

    # --- launches ---------------------------------------------------------
    def _launch(self, k: int) -> None:
        """Launch entry point ``k`` (0 serve, 1 commit) over every filled
        block, on the current stream."""
        if self._fns is None:
            lib = _build.load("point_update")
            self._fns = (lib.point_serve, lib.point_commit)
        fn = self._fns[k]
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        with torch.cuda.device(self.dev):
            for b in self._blocks:
                err = fn(b.addr, b.w.shape[0], stream)
                if err:
                    _build.check(err, ("point_serve", "point_commit")[k])
                launches["point_update"] += 1

    def serve(self, idx, t, z, size, gd_clock, active=None,
              fresh=None) -> None:
        """Serve the request at time ``t`` (f32) at object ``idx[l]`` of
        every lane (an int: the same object everywhere); ``z`` and
        ``size`` are f32 host values (one, or one a lane), ``gd_clock`` an
        f32 [L] array, ``active`` a bool [L] mask (None: every lane),
        ``fresh`` a slot table's first touch ``(key, z_prior)``
        (:func:`~repro_torch.kernels.ref.point_serve_ref`)."""
        if not self.kernel:
            fr = None
            if fresh is not None:
                fr = (*self.table, int(fresh[0]),
                      torch.tensor(np.float32(fresh[1]), device=self.dev))
            point_serve_ref(
                self.values, self.flags, self._t(idx, torch.int64),
                torch.tensor(np.float32(np.asarray(t).reshape(-1)[0]),
                             device=self.dev),
                self._t(z, torch.float32), self._t(size, torch.float32),
                self._t(gd_clock, torch.float32), self.lane,
                None if active is None else self._t(active, torch.bool),
                fr)
            return
        if fresh is not None and self.table is None:
            raise ValueError("a first touch needs the slot table")
        # f32 host arrays: f32 values assigned to f32 views, bit for bit
        t = np.asarray(t, np.float32).reshape(-1)[0]
        for b in self._blocks:
            sl = b.sl
            b.wf[12] = t
            b.w[13] = fresh is not None
            if fresh is not None:
                b.w[14] = fresh[0]
                b.wf[15] = fresh[1]
            b.rec[:, 0] = idx if np.ndim(idx) == 0 else idx[sl]
            b.rec[:, 1] = (b.on if active is None
                           else b.base | (ACTIVE * active[sl]))
            b.rec_f[:, 2] = z if np.size(z) == 1 else z[sl]
            b.rec_f[:, 3] = gd_clock[sl]
            b.rec_f[:, 4] = size if np.size(size) == 1 else size[sl]
        self._launch(0)

    def commit(self, idx, due, size, gd_clock) -> None:
        """Commit the fetch of object ``idx[l]`` on every lane with
        ``due[l]`` (:func:`~repro_torch.kernels.ref.point_commit_ref`);
        ``idx`` an int [L] array, ``due`` a bool one, ``size`` and
        ``gd_clock`` f32 ones."""
        if not self.kernel:
            point_commit_ref(
                self.values, self.flags, self._t(idx, torch.int64),
                self._t(due, torch.bool), self._t(size, torch.float32),
                self._t(gd_clock, torch.float32), self.lane,
                self.estimate_z)
            return
        for b in self._blocks:
            sl = b.sl
            b.w[12] = self.estimate_z
            b.rec[:, 0] = idx[sl]
            b.rec[:, 1] = b.base | (ACTIVE * due[sl])
            b.rec_f[:, 3] = gd_clock[sl]
            b.rec_f[:, 4] = size[sl]
        self._launch(1)
