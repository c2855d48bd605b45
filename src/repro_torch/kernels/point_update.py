"""The replay engine's point updates on the card (``csrc/point_update.cu``),
as a journal: the engine queues its serves, commits and cached-bit writes,
and one launch applies them in order when the state is next read.

A serve or a commit acts at one object per lane of the ``[12, L, N]`` f32
/ ``[2, L, N]`` bool state; a cached-bit write sets ``cached`` at one
object per lane.  The engine decides everything on the host from its
mirror and reads the card only to score and to pick a victim, so the
writes in between can wait: :meth:`PointUpdate.flush` runs before each of
those reads and sends the queued ops, in order, in as few launches as
their records need (one a parameter block).  The commit's three
statistics (``agg_sum``, ``agg_sq_sum``, ``agg_cnt``) are adds on the
card, as the JAX reference's ``lane_add`` (the add half of its
``lane_scatter`` kernel) makes them.

:class:`PointUpdate` holds one engine's state, its lanes' constants and,
for each group of up to :data:`MAX_LANES` lanes, a journal: the host
words of one parameter block (a header, one 6-word record an op, then the
ops' data, only what differs between lanes), which an append fills and a
launch takes with no copy to the card.  A full block goes out before the
op that would overflow it.  On a CUDA state the journal launches the
kernel (or raises); on a CPU state, or with ``plain=True`` on any device,
its flush decodes the same words and applies the ops one by one through
the plain versions :func:`repro_torch.kernels.ref.point_serve_ref`,
:func:`~repro_torch.kernels.ref.point_commit_ref` and an indexed set.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from . import _build
from .ref import point_commit_ref, point_serve_ref

# Kernel launches, one per launch on the card.
launches = {"point_update": 0}

# The parameter block of csrc/point_update.cu, in int32 words: a header,
# one record an op, then the ops' data.
HEAD_WORDS, OP_WORDS = 20, 6
BLOCK_WORDS = 8190                  # the largest of the kernel's blocks
MAX_OPS = (BLOCK_WORDS - HEAD_WORDS) // OP_WORDS
MAX_LANES = 512                     # lanes a journal; more take several
# an op record's code: its kind, then which operands are per lane
SERVE, COMMIT, SET = 0, 1, 2
IDX, Z, SIZE, CLOCK, FRESH, VALUE = 4, 8, 16, 32, 64, 128
# a lane's constant flags
GD, GD_RATE = 2, 4

_OP = struct.Struct("<2i3fi")       # code, idx, t, z, size, data offset


def _ptr(words, at: int, ptr: int) -> None:
    """A device pointer into two words (low, high)."""
    words[at:at + 2] = np.array([ptr & 0xffffffff, ptr >> 32],
                                np.uint32).view(np.int32)


def _num(x) -> float:
    """A host number (a Python or numpy scalar, or a one-element array)."""
    return x.item() if isinstance(x, np.ndarray) else float(x)


def _per_lane(x) -> bool:
    """Whether an operand holds one value a lane (else one for all)."""
    return isinstance(x, np.ndarray) and x.size > 1


class _Journal:
    """The queued ops of lanes ``sl`` (``nl`` of them; ``gd`` whether any
    is a GreedyDual lane, whose ops then carry the clock): the header and
    op records in ``head``, the ops' data in ``data``, ``k`` ops and ``d``
    data words so far."""

    def __init__(self, sl: slice, gd: bool):
        self.sl, self.nl, self.gd = sl, sl.stop - sl.start, gd
        self.head = np.zeros(HEAD_WORDS + OP_WORDS * MAX_OPS, np.int32)
        self.head[0], self.head[1] = self.nl, sl.start
        self.ops = self.head[HEAD_WORDS:].reshape(MAX_OPS, OP_WORDS)
        self.data = np.zeros(BLOCK_WORDS, np.int32)
        self.data_f = self.data.view(np.float32)
        self.addr = (self.head.ctypes.data, self.data.ctypes.data)
        self.k = self.d = 0


class PointUpdate:
    """The point updates of one engine's state, queued in journals.

    ``values`` f32 [12, L, N] and ``flags`` bool [2, L, N] (contiguous, on
    one device); ``gd``, ``gd_rate`` (bool [L]), ``cold_rate``,
    ``gap_alpha`` (f32 [L]) the lanes' policy constants; ``eps`` the
    estimators' floor; ``table`` a one-lane slot engine's ``(key_tab,
    sizes)``, which a first touch writes.  ``plain`` runs the plain
    versions on any device."""

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
        if table is not None and self.L != 1:
            raise ValueError("a slot table takes a one-lane state")
        f32 = lambda x: np.broadcast_to(np.asarray(x, np.float32),
                                        (self.L,))
        lane_t = lambda x, dt: torch.as_tensor(np.array(x), dtype=dt,
                                               device=self.dev)
        gd = np.broadcast_to(np.asarray(gd, bool), (self.L,))
        gd_rate = np.broadcast_to(np.asarray(gd_rate, bool), (self.L,))
        self.lane = (lane_t(gd, torch.bool), lane_t(gd_rate, torch.bool),
                     lane_t(f32(cold_rate), torch.float32),
                     lane_t(f32(gap_alpha), torch.float32),
                     float(np.float32(eps)))
        self.n_ops = self.n_blocks = 0      # ops appended, blocks sent
        self._journals = [
            _Journal(slice(l0, min(l0 + MAX_LANES, self.L)),
                     bool(gd[l0:l0 + MAX_LANES].any()))
            for l0 in range(0, self.L, MAX_LANES)]
        for jn in self._journals:
            w = jn.head
            w[2], w[3], w[15] = self.L, self.N, self.estimate_z
            w[16:17].view(np.float32)[0] = eps
        if not self.kernel:
            return
        for x in (values, flags) + (tuple(table) if table else ()):
            if not x.is_contiguous():
                raise ValueError("the state must be contiguous (it is "
                                 "updated in place)")
        if values.dtype != torch.float32 or flags.dtype != torch.bool:
            raise ValueError("values must be f32 and flags bool")
        consts = np.zeros((self.L, 4), np.int32)
        consts[:, 0] = GD * gd | GD_RATE * gd_rate
        consts[:, 1:3].view(np.float32)[:] = np.stack(
            [f32(cold_rate), f32(gap_alpha)], 1)
        self._consts = torch.as_tensor(consts, device=self.dev)
        for jn in self._journals:
            w = jn.head
            _ptr(w, 4, values.data_ptr())
            _ptr(w, 6, flags.data_ptr())
            if table is not None:
                _ptr(w, 8, table[0].data_ptr())
                _ptr(w, 10, table[1].data_ptr())
            _ptr(w, 12, self._consts.data_ptr())
        self._fn = None             # the C entry point, at first launch

    # --- the journal --------------------------------------------------------
    @property
    def pending(self) -> int:
        """Ops queued and not yet applied."""
        return sum(jn.k for jn in self._journals)

    @property
    def pending_bytes(self) -> int:
        """Bytes of the parameter blocks that the queued ops fill."""
        return 4 * sum(HEAD_WORDS + OP_WORDS * jn.k + jn.d
                       for jn in self._journals if jn.k)

    def _push(self, code: int, i, t, z, size, fresh, lanes,
              gd_code: int = 0, gd_lanes=()) -> None:
        """Queue one op on every journal: its record ``(code, i, t, z,
        size)``, a first touch's ``(key, z prior)`` and the per-lane
        arrays ``lanes`` ([L] each, in data order), then on journals with a
        GreedyDual lane the arrays ``gd_lanes`` too, flagged ``gd_code``."""
        self.n_ops += 1
        for jn in self._journals:
            nl, c, cols = jn.nl, code, lanes
            if jn.gd and gd_code:
                c |= gd_code
                cols = lanes + list(gd_lanes)
            nd = nl * len(cols) + (2 if fresh is not None else 0)
            if HEAD_WORDS + OP_WORDS * (jn.k + 1) + jn.d + nd > \
                    BLOCK_WORDS:
                self._send(jn)
            d = jn.d
            _OP.pack_into(jn.ops, jn.k * OP_WORDS * 4, c, i, t, z, size, d)
            if fresh is not None:
                jn.data[d] = fresh[0]
                jn.data_f[d + 1] = fresh[1]
                d += 2
            for n, a in enumerate(cols):
                a = np.asarray(a)
                (jn.data if n == 0 and c & IDX else jn.data_f)[
                    d:d + nl] = a[jn.sl]
                d += nl
            jn.k += 1
            jn.d = d

    def serve(self, idx, t, z, size, gd_clock, active=None,
              fresh=None) -> None:
        """Queue the serve of the request at time ``t`` (f32) at object
        ``idx[l]`` of every lane (an int: the same object everywhere);
        ``z`` and ``size`` are f32 host values (one, or one a lane),
        ``gd_clock`` an f32 [L] array, ``active`` a bool [L] mask (None:
        every lane), ``fresh`` a slot table's first touch ``(key,
        z_prior)`` (:func:`~repro_torch.kernels.ref.point_serve_ref`)."""
        if fresh is not None and self.table is None:
            raise ValueError("a first touch needs the slot table")
        code, lanes, i, zs, sz = SERVE, [], 0, 0.0, 0.0
        if active is not None:
            code |= IDX
            lanes.append(np.where(active, idx, -1))
        elif isinstance(idx, (int, np.integer)):
            i = idx
        else:
            code |= IDX
            lanes.append(idx)
        if _per_lane(z):
            code |= Z
            lanes.append(z)
        else:
            zs = _num(z)
        if _per_lane(size):
            code |= SIZE
            lanes.append(size)
        else:
            sz = _num(size)
        if fresh is not None:
            code |= FRESH
        self._push(code, i, _num(t), zs, sz, fresh, lanes, CLOCK,
                   [gd_clock])

    def commit(self, idx, due, size, gd_clock) -> None:
        """Queue the commit of the fetch of object ``idx[l]`` on every lane
        with ``due[l]`` (:func:`~repro_torch.kernels.ref.point_commit_ref`);
        ``idx`` an int [L] array, ``due`` a bool one, ``size`` and
        ``gd_clock`` f32 ones, which only GreedyDual lanes read."""
        self._push(COMMIT | IDX, 0, 0.0, 0.0, 0.0, None,
                   [np.where(due, idx, -1)], SIZE | CLOCK, [size, gd_clock])

    def set_cached(self, idx, lanes_mask, value: bool) -> None:
        """Queue ``cached[l, idx[l]] = value`` on every lane with
        ``lanes_mask[l]``; ``idx`` an int [L] array."""
        self._push(SET | IDX | (VALUE if value else 0), 0, 0.0, 0.0, 0.0,
                   None, [np.where(lanes_mask, idx, -1)])

    def flush(self) -> None:
        """Apply every queued op, in order: one launch a journal with ops
        on the card (no sync), the plain versions one op at a time
        otherwise."""
        for jn in self._journals:
            if jn.k:
                self._send(jn)

    def _send(self, jn: _Journal) -> None:
        """Apply ``jn``'s block and empty it."""
        self.n_blocks += 1
        if self.kernel:
            if self._fn is None:
                self._fn = _build.load("point_update").point_journal
            jn.head[14] = jn.k
            # the raw stream of the state's device, made current if it is
            # not (the context manager alone costs more than the launch)
            dev = self.dev.index
            if torch.cuda.current_device() == dev:
                err = self._launch(jn, dev)
            else:
                with torch.cuda.device(dev):
                    err = self._launch(jn, dev)
            _build.check(err, "point_journal")
            launches["point_update"] += 1
        else:
            self._apply_plain(jn)
        jn.k = jn.d = 0

    def _launch(self, jn: _Journal, dev: int) -> int:
        """Launch ``jn``'s block on device ``dev``'s current stream."""
        return self._fn(jn.addr[0], HEAD_WORDS + OP_WORDS * jn.k, jn.addr[1],
                        jn.d, torch._C._cuda_getCurrentRawStream(dev))

    # --- the plain route -----------------------------------------------------
    def _apply_plain(self, jn: _Journal) -> None:
        """Decode ``jn``'s block as the kernel reads it and apply its ops
        one by one through the plain versions."""
        dev, nl = self.dev, jn.nl
        values, flags = self.values[:, jn.sl], self.flags[:, jn.sl]
        lane = tuple(x[jn.sl] for x in self.lane[:4]) + self.lane[4:]
        rows = torch.arange(nl, device=dev)
        ops = jn.ops[:jn.k]
        ops_f = ops.view(np.float32)
        t_ = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
        for k in range(jn.k):
            code, at = int(ops[k, 0]), int(ops[k, 5])
            fresh = None
            if code & FRESH:
                fresh = (*self.table, int(jn.data[at]),
                         t_(jn.data_f[at + 1], torch.float32))
                at += 2
            col = {}
            for flag, src in ((IDX, jn.data), (Z, jn.data_f),
                              (SIZE, jn.data_f), (CLOCK, jn.data_f)):
                if code & flag:
                    col[flag] = src[at:at + nl].copy()
                    at += nl
            full = lambda flag, v, dt: col.get(flag, np.full(nl, v, dt))
            idx = full(IDX, ops[k, 1], np.int32).astype(np.int64)
            on = idx >= 0
            idx0 = t_(np.where(on, idx, 0), torch.int64)
            size = t_(full(SIZE, ops_f[k, 4], np.float32), torch.float32)
            clock = t_(full(CLOCK, 0.0, np.float32), torch.float32)
            kind = code & 3
            if kind == SERVE:
                point_serve_ref(
                    values, flags, idx0, t_(ops_f[k, 2], torch.float32),
                    t_(full(Z, ops_f[k, 3], np.float32), torch.float32),
                    size, clock, lane,
                    None if on.all() else t_(on, torch.bool), fresh)
            elif kind == COMMIT:
                point_commit_ref(values, flags, idx0, t_(on, torch.bool),
                                 size, clock, lane, self.estimate_z)
            else:
                sel = t_(on, torch.bool)
                flags[0, rows[sel], idx0[sel]] = bool(code & VALUE)
