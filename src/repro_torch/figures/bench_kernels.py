"""Kernel timings: the port's hand-written kernels at the main path's
shapes, beside their bounds, their plain versions and a library call.

    python3 -m repro_torch.figures.bench_kernels [--device cpu]
    python3 -m repro_torch.figures.run --only kernels

On the card every time is the median CUDA-event time of one call
(:func:`time_ms`), queued behind a sleep kernel so the host's launch cost
does not show.  Each row gives the kernel's time (``us``), its plain
version's (``plain_us``), the least time an H100 SXM could take for the
same work (``bound_us``, the larger of the bytes the call must move at
3.35 TB/s and its operations at 67 TFLOP/s f32 or 989 TFLOP/s bf16; how
it was reckoned in ``bound_how``) and, where one PyTorch call computes
the same function, that call's time (``library``, ``library_us``).

On the CPU (``device="cpu"``) the wrappers run their plain versions, so
only ``plain_us`` and ``library_us`` are measured (host clock), at small
shapes, and ``us`` is None.

Shapes on the card: the ranking kernels at N = 100 (fig2's table) and
2^20 (the deployment table), the point-update journal's flush of 1, 4,
16 and 256 ops over 1 and 18 lanes at both; the lane scatter at the
serving flush (4 objects into the mirror of 4,096 and 2^18); the attention
kernels at StableLM-2-1.6B's (B 1, 32 heads of 64, 2048 tokens) and
Hymba-1.5B's shapes (25 q / 5 KV heads of 64, window 1024, a 128-token
sink); ``gla_chunk`` at xLSTM-350M's and Hymba-1.5B's prefill, bf16.
``chip_smoke.py`` takes its kernel timings from here.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS = 67e12             # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate
TOP = 8                       # the simulator's EVICT_TOP
N_DEPLOY = 1 << 20            # the deployment table
# the serving engine's mirror tables (its default and the 2^18-object
# prefix table of chip_smoke.py's phase 13(b)) and the objects a flush
# writes (13(b)'s mean, 3.97-4.03)
FLUSH_TABLES = (4096, 1 << 18)
FLUSH_OBJECTS = 4


def time_ms(fn, reps: int = 100, device="cuda") -> float:
    """Median time of one ``fn()`` call over ``reps`` calls, in ms: CUDA
    events around each call on the card (the calls queued behind a sleep
    kernel), the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def ranking_inputs(n: int, density, seed: int, device="cuda"):
    """Eq.-16 inputs on ``device``; an eighth of the elements repeat other
    elements' inputs exactly, so scores tie across tiles."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g,
                                                   device=device)
    lam, z, resid, sizes = u(1e-3, 50.0), u(1e-3, 2.0), u(1e-3, 10.0), \
        u(1.0, 100.0)
    dst = torch.randperm(n, generator=g, device=device)[:n // 8]
    src = torch.randperm(n, generator=g, device=device)[:n // 8]
    for x in (lam, z, resid, sizes):
        x[dst] = x[src]
    if density == "sparse":          # 2 cached per 1024-tile (< TOP)
        cached = torch.zeros(n, dtype=torch.bool, device=device)
        cached[3::1024] = True
        cached[700::1024] = True
    else:
        cached = torch.rand(n, generator=g, device=device) < density
    return lam, z, resid, sizes, cached


def _row(name, shape, dev, ms, plain_ms, bound_ms, bound_by, bound_how,
         library=None, library_ms=None, **extra) -> dict:
    us = lambda x: None if x is None else x * 1e3
    return dict(name=name, shape=shape, device=str(dev), us=us(ms),
                plain_us=us(plain_ms), bound_us=us(bound_ms),
                bound_by=bound_by, bound_how=bound_how, library=library,
                library_us=us(library_ms), **extra)


def _kernel_ms(dev, fn, reps):
    """The kernel's time on the card; None on the CPU, where the wrapper
    runs the plain version."""
    return time_ms(fn, reps, dev) if dev.type == "cuda" else None


def time_ranking(dev, sizes=(100, N_DEPLOY), reps=100) -> list[dict]:
    """``ranking_victim_order`` (top 8) and ``ranking_scores`` at each N
    of ``sizes``, half the table cached."""
    from ..kernels import ref
    from ..kernels.ranking_score import ranking_scores, ranking_victim_order
    rows = []
    for n in sizes:
        args = ranking_inputs(n, 0.5, seed=1234, device=dev)
        # four f32 inputs and the cached flag read, an f32 score written;
        # 16 operations an element
        base = max(n * (4 * 4 + 1 + 4) / HBM_BYTES_PER_S, n * 16 / F32_FLOPS)
        how = (f"{n} x (4 f32 inputs + 1 flag + 1 f32 score) B at 3.35 "
               f"TB/s vs {n} x 16 f32 operations at 67 TFLOP/s")
        rows.append(_row(
            "ranking_victim_order", f"N={n}, top {TOP}", dev,
            _kernel_ms(dev, lambda: ranking_victim_order(
                *args, omega=1.0, top=TOP), reps),
            time_ms(lambda: ref.ranking_victim_order_ref(*args, 1.0, TOP),
                    reps, dev),
            (base + TOP * 8 / HBM_BYTES_PER_S) * 1e3, "bytes",
            how + f"; + {TOP} x 8 B of victim order", n=n))
        rows.append(_row(
            "ranking_scores", f"N={n}", dev,
            _kernel_ms(dev, lambda: ranking_scores(*args, omega=1.0), reps),
            time_ms(lambda: ref.ranking_scores_ref(*args, 1.0), reps, dev),
            (base + 8 / HBM_BYTES_PER_S) * 1e3, "bytes",
            how + "; + 8 B of argmin", n=n))
    return rows


def time_lane_scatter(dev, sizes=FLUSH_TABLES, reps=100) -> list[dict]:
    """The serving flush (``serving.engine.DelayedHitPrefixCache.flush``,
    the one path that launches the lane scatter): ``FLUSH_OBJECTS``
    objects written into the device mirror, each one write of its 9 f32
    rows into ``[9, N]`` and one of its 2 flags into ``[2, N]``, as one
    ``lane_scatter_batch`` call over each N of ``sizes``; as two
    ``index_put_`` (the library call); and at the largest N one batch call
    on the host clock."""
    from ..kernels import ref
    from ..kernels.lane_scatter import lane_scatter_batch
    rng = np.random.default_rng(7)
    k = FLUSH_OBJECTS

    def flush_writes(n):
        vals = torch.zeros((9, n), dtype=torch.float32, device=dev)
        flags = torch.zeros((2, n), dtype=torch.bool, device=dev)
        writes = []
        for i in rng.choice(n, k, replace=False).tolist():
            writes.append((vals, np.full(9, i, np.int32),
                           rng.random(9, np.float32), None, False))
            writes.append((flags, np.full(2, i, np.int32),
                           rng.random(2) < 0.5, None, False))
        return writes

    # each row's index and value read, its element written
    bound = k * (9 * (4 + 4 + 4) + 2 * (4 + 4 + 1)) / HBM_BYTES_PER_S * 1e3
    how = (f"{k} objects x (9 f32 rows x (4 + 4 + 4) B + 2 bool rows x "
           f"(4 + 4 + 1) B)")
    rows = []
    for n in sizes:
        writes = flush_writes(n)
        # the library call: one index_put_ a mirror tensor, its (row,
        # column) pairs and values gathered from the flush's writes
        ops = []
        for x in (writes[0][0], writes[1][0]):
            mine = [w for w in writes if w[0] is x]
            ops.append((x, torch.as_tensor(np.concatenate(
                [np.arange(x.shape[0]) for _ in mine]), device=dev),
                torch.as_tensor(np.concatenate([w[1] for w in mine]),
                                dtype=torch.long, device=dev),
                torch.as_tensor(np.concatenate([w[2] for w in mine]),
                                device=dev)))

        def library():
            for x, r, i, v in ops:
                x.index_put_((r, i), v)

        extra = {}
        if dev.type == "cuda" and n == max(sizes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                lane_scatter_batch(writes)
            torch.cuda.synchronize()
            extra["host_call_us"] = (time.perf_counter() - t0) * 1e3
        rows.append(_row(
            "lane_scatter", f"the serving flush of {k} objects, N={n}", dev,
            _kernel_ms(dev, lambda: lane_scatter_batch(writes), reps),
            time_ms(lambda: ref.lane_scatter_batch_ref(writes), reps, dev),
            bound, "bytes", how, "2 x index_put_",
            time_ms(library, reps, dev), n=n, main=(n == max(sizes)),
            **extra))
    return rows


def point_state(lanes: int, n: int, seed: int, device):
    """A random ``[12, L, N]`` f32 / ``[2, L, N]`` bool simulator state on
    ``device`` with the engine's edge values: ``complete_t`` inf where no
    fetch is out, counts 0, 1 and more, empty episode statistics."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (lanes, n), generator=g, device=device)
    pick = lambda p: torch.rand((lanes, n), generator=g, device=device) < p
    count = torch.floor(u(0.0, 6.0))
    values = torch.stack([
        torch.where(pick(0.4), float("inf"), u(0.0, 50.0)),   # complete_t
        u(0.0, 40.0), torch.where(count > 0, u(0.0, 40.0), -float("inf")),
        torch.where(count > 0, u(0.0, 20.0), -float("inf")),
        u(0.0, 2.0), count, u(1e-3, 0.05),                     # ... z_est
        u(0.0, 1.0), u(0.0, 1.0), torch.floor(u(0.0, 3.0)),   # agg_*
        u(0.0, 0.1), u(0.0, 5.0)]).contiguous()                # ep, gd_h
    flags = torch.stack([pick(0.5), pick(0.3)]).contiguous()
    return values, flags


def point_lanes(lanes: int, seed: int):
    """Random lane constants ``(gd, gd_rate, cold_rate, gap_alpha)``: half
    the lanes GreedyDual, half of those with the rate cost."""
    rng = np.random.default_rng(seed)
    gd = rng.random(lanes) < 0.5
    return (gd, gd & (rng.random(lanes) < 0.5),
            rng.uniform(0.5, 2.0, lanes).astype(np.float32),
            rng.choice(np.float32([0.01, 0.1, 0.5]), lanes))


def journal_ops(rng, lanes: int, n: int, n_ops: int, slot: bool = False,
                hot: int = 3, p_hot: float = 0.7, masks: bool = True) -> list:
    """A random journal of ``n_ops`` point-update ops for ``lanes`` lanes
    over ``n`` objects, as ``(kind, args)`` for :func:`push_ops`: serves
    (one object for every lane or one a lane; z and size one or one a
    lane; masked lanes or none; on a slot table, first touches), commits
    (lanes not due) and cached-bit sets (lanes left out), at one of
    ``hot`` objects with probability ``p_hot`` (chains of ops at one
    point) and anywhere else otherwise; ``masks=False`` leaves no lane
    out."""
    hot_objs = rng.integers(0, n, hot)
    pick = lambda k: np.where(rng.random(k) < p_hot,
                              rng.choice(hot_objs, k), rng.integers(0, n, k))
    f32 = lambda lo, hi, k=None: (np.float32(rng.uniform(lo, hi)) if k is None
                                  else rng.uniform(lo, hi, k).astype(
                                      np.float32))
    some = lambda: (rng.random(lanes) < 0.7 if masks
                    else np.ones(lanes, bool))
    t = f32(0.0, 40.0)
    ops = []
    for _ in range(n_ops):
        t = np.float32(t + f32(0.0, 0.01))
        idx = pick(lanes).astype(np.int64)
        clock = f32(0.0, 5.0, lanes)
        u = rng.random()
        if u < 0.5:
            one = rng.random() < 0.5
            ops.append(("serve", (
                int(idx[0]) if one else idx, np.float32([t]),
                np.float32([f32(1e-3, 0.05)]) if rng.random() < 0.5
                else f32(1e-3, 0.05, lanes),
                f32(1.0, 100.0) if rng.random() < 0.5
                else f32(1.0, 100.0, lanes), clock,
                None if rng.random() < 0.6 or not masks else some(),
                (int(rng.integers(0, 1 << 30)), f32(1e-3, 0.05))
                if slot and rng.random() < 0.3 else None)))
        elif u < 0.75:
            ops.append(("commit", (idx, some(),
                                   f32(1.0, 100.0, lanes), clock)))
        else:
            ops.append(("set", (idx, some(),
                                bool(rng.random() < 0.5))))
    return ops


def push_ops(pu, ops) -> None:
    """Queue ``ops`` (:func:`journal_ops`) on a ``PointUpdate``."""
    for kind, a in ops:
        if kind == "serve":
            pu.serve(*a)
        elif kind == "commit":
            pu.commit(*a)
        else:
            pu.set_cached(*a)


# The state rows an op reads and writes at its point, in any branch: f32
# fields 0-11 (kernels.ref's CT ... GH), then the flags cached (12) and
# in_flight (13); ``gd`` is a GreedyDual lane's extra, ``ez`` the z
# estimate's (estimate_z on).
CT, IT, LA, FA, GM, CNT, ZE, AS, AQ, AC, EP, GH, CACHED, IN_FLIGHT = \
    range(14)
POINT_ROWS = {
    "serve": dict(reads={CACHED, IN_FLIGHT, CT, EP, LA, GM, CNT},
                  writes={CT, IT, EP, GM, FA, LA, CNT, CACHED, IN_FLIGHT},
                  gd_reads={AS, AC, ZE}, gd_writes={GH}),
    "commit": dict(reads={EP, AS, AQ, AC},
                   writes={AS, AQ, AC, EP, CT, IN_FLIGHT},
                   gd_reads={ZE, GM, CNT}, gd_writes={GH},
                   ez_reads={CT, IT, ZE}, ez_writes={ZE}),
    "set": dict(reads=set(), writes={CACHED})}


def journal_bytes(ops, gd, estimate_z: bool) -> tuple[int, int]:
    """``(points, bytes)``: the distinct (lane, object) points that a
    journal's ops (:func:`journal_ops`) touch on lanes with GreedyDual
    flags ``gd`` (bool [L]), and the bytes the state must move for them:
    at each point the rows (4 B a field, 1 B a flag) that its ops read
    before an earlier op there wrote them, and every row they write
    (:data:`POINT_ROWS`); a slot table's first touch reads no row, writes
    all 14 and the slot's key and size (4 B each)."""
    lanes = len(gd)
    rows = {}                       # point -> (rows read, rows written)
    extra = 0
    for kind, a in ops:
        idx = np.broadcast_to(np.asarray(a[0]), (lanes,))
        on = (np.ones(lanes, bool) if kind == "serve" and a[5] is None
              else a[5] if kind == "serve" else a[1])
        fresh = kind == "serve" and a[6] is not None
        use = POINT_ROWS[kind]
        for lane in np.flatnonzero(on).tolist():
            read, wrote = rows.setdefault((lane, int(idx[lane])),
                                          (set(), set()))
            if fresh:
                wrote.update(range(14))
                extra += 8
                continue
            r, w = set(use["reads"]), set(use["writes"])
            if gd[lane]:
                r |= use.get("gd_reads", set())
                w |= use.get("gd_writes", set())
            if estimate_z:
                r |= use.get("ez_reads", set())
                w |= use.get("ez_writes", set())
            read |= r - wrote
            wrote |= w
    size = lambda rs: sum(1 if x >= CACHED else 4 for x in rs)
    return len(rows), extra + sum(size(r) + size(w)
                                  for r, w in rows.values())


JOURNAL_KS = (1, 4, 7, 16, 256)   # ops a flush, timed
JOURNAL_LANES = (1, 18)           # one-lane replays; the 18-lane grid
# The kernels line's flush: the replays' mean flush holds 5.5-7.6 ops
# (chip_smoke.py phases 2, 3, 11 and 12(b); 99th percentile 16-35)
MAIN_K = 7


def time_point_update(dev, sizes=(100, N_DEPLOY), reps=100) -> list[dict]:
    """One flush of a journal of K ops (:data:`JOURNAL_KS`: random
    serves, commits and cached-bit sets at random objects) over L lanes
    (:data:`JOURNAL_LANES`) at each N of ``sizes``, kernel beside plain
    version; on the card also the host cost of an appended op (the mixed
    journal's, and the engine's common serve: one object, one z, no mask)
    and of a flush call.  The row at L = 1, K = :data:`MAIN_K` and the
    largest N is ``main``.  Each timed call appends its K ops and
    flushes; the appends stay ahead of the card behind :func:`time_ms`'s
    sleep kernel (fewer calls at large K), so the events time the
    launches alone."""
    from ..core.ranking import EPS
    from ..kernels.point_update import PointUpdate
    rows = []
    for n in sizes:
        for lanes in JOURNAL_LANES:
            values, flags = point_state(lanes, n, 11, dev)
            lane = point_lanes(lanes, 11)
            kern = PointUpdate(values, flags, *lane, EPS, True)
            plain = PointUpdate(values, flags, *lane, EPS, True, plain=True)
            for k in JOURNAL_KS:
                ops = journal_ops(np.random.default_rng(k), lanes, n, k,
                                  p_hot=0.0, masks=False)
                pts, nbytes = journal_bytes(ops, lane[0], True)
                push_ops(plain, ops)
                block = plain.pending_bytes
                plain.flush()
                flush = lambda pu: (push_ops(pu, ops), pu.flush())
                extra = {}
                if dev.type == "cuda" and k == max(JOURNAL_KS):
                    extra = _journal_host_us(kern, ops, lanes)
                rows.append(_row(
                    "point_update", f"flush of K={k} ops, L={lanes}, N={n}",
                    dev, _kernel_ms(dev, lambda: flush(kern),
                                    min(reps, max(10, 400 // k))),
                    time_ms(lambda: flush(plain), max(3, reps // k), dev),
                    (nbytes + block + 16 * lanes) / HBM_BYTES_PER_S * 1e3,
                    "bytes", f"{pts} touched points: {nbytes} B of their "
                    f"fields and flags (journal_bytes), {block} B of "
                    f"parameter block, {16 * lanes} B of lane constants, "
                    f"at 3.35 TB/s", n=n, lanes=lanes, ops=k, points=pts,
                    main=(lanes == 1 and k == MAIN_K and n == max(sizes)),
                    **extra))
    return rows


def _journal_host_us(pu, ops, lanes: int, rounds: int = 20) -> dict:
    """Host microseconds an appended op (``ops``, and the engine's common
    serve) and a flush call, on the host clock, the card synchronised
    between rounds."""
    def clock(fn):
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
            pu.flush()
        return best * 1e6
    t, z = np.float32([30.0]), np.float32([0.01])
    size, gd_clock = np.float32(7.0), np.zeros(lanes, np.float32)
    serves = lambda: [pu.serve(5, t, z, size, gd_clock) for _ in range(64)]
    pu.flush()
    mixed = clock(lambda: push_ops(pu, ops)) / len(ops)
    serve = clock(serves) / 64

    def one_flush():
        push_ops(pu, ops[:4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pu.flush()
        return time.perf_counter() - t0
    torch.cuda.synchronize()
    flush_us = min(one_flush() for _ in range(rounds)) * 1e6
    return dict(append_us=mixed, serve_append_us=serve,
                flush_host_us=flush_us)


def attention_bound(q, k, q_pos, k_pos, kw):
    """(bound ms, bound_by, split-P work ms, how): the larger of the
    operations (q.k and p.v over the visible pairs) at the bf16 tensor
    rate and the bytes (q, k, v, out and the positions, each once) at
    3.35 TB/s; also the tensor-core prefill kernel's split-P work (p.v
    twice: p as bf16 hi + lo)."""
    from ..kernels import ref
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    pairs = int(ref.attention_keep(q_pos, k_pos, kw.get("window", 0),
                                   kw.get("sink", 0)).sum()) * b * h
    flops = 2 * 2 * pairs * dh
    nbytes = (2 * b * sq * h + 2 * b * sk * kv) * dh * q.element_size() \
        + (sq + sk) * 4
    ops_ms = flops / BF16_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    how = (f"{flops / 1e9:.3f} GFLOP at 989 TFLOP/s vs "
           f"{nbytes / 1e6:.3f} MB at 3.35 TB/s")
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms > bytes_ms else "bytes",
            1.5 * flops / BF16_FLOPS * 1e3, how)


def attention_inputs(dev, small: bool) -> dict:
    """The attention kernels' timed inputs, bf16 on the card (f32 on the
    CPU), by cell: (q, k, v, q_pos, k_pos, kw) for prefill, and the
    decode query with several caches (timed in turn, so each call finds
    its cache out of the 50 MB L2, as a layer of the model does)."""
    dt = torch.float32 if dev.type == "cpu" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(dt)
    ipos = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    # StableLM-2-1.6B: causal prefill and decode over a full cache
    s, h, dh, n_caches = (256, 4, 64, 2) if small else (2048, 32, 64, 4)
    pos = ipos(range(s))
    out = {"StableLM": dict(
        prefill=(rnd(1, s, h, dh), rnd(1, s, h, dh), rnd(1, s, h, dh),
                 pos, pos, {}),
        decode=(rnd(1, 1, h, dh), [(rnd(1, s, h, dh), rnd(1, s, h, dh))
                                   for _ in range(n_caches)],
                ipos([s - 1]), pos, {}),
        what=f"B=1, S={s}, {h} heads of {dh}, causal")}
    # StableLM-2-1.6B's 32k cells: prefill_32k at batch 1 and decode_32k at
    # its batch on one device of the 16-wide data axis (8), a full cache
    s, h, dh, b_dec, n_caches = (512, 4, 64, 2, 2) if small else (
        32768, 32, 64, 8, 2)
    pos = ipos(range(s))
    out["StableLM 32k"] = dict(
        prefill=(rnd(1, s, h, dh), rnd(1, s, h, dh), rnd(1, s, h, dh),
                 pos, pos, {}),
        decode=(rnd(b_dec, 1, h, dh), [(rnd(b_dec, s, h, dh),
                                        rnd(b_dec, s, h, dh))
                                       for _ in range(n_caches)],
                ipos([s - 1]), pos, {}),
        what=f"B=1 prefill / B={b_dec} decode, S={s}, {h} heads of {dh}, "
             f"causal")
    # Hymba-1.5B: prefill over meta + prompt tokens, decode over a wrapped
    # ring (sink slots in place, ring slots holding positions out of
    # order) with empty slots
    h, kv, dh, meta, win, prompt, n_rings = (
        (5, 1, 64, 16, 64, 240, 2) if small
        else (25, 5, 64, 128, 1024, 2048, 40))
    s, ring = meta + prompt, meta + win
    kpos = [i if i < meta else meta + (s - meta - win)
            + ((i - meta) + 300) % win for i in range(ring)]
    for i in range(meta + 7, ring, 97):
        kpos[i] = -1
    kw = dict(window=win, softcap=0.0, sink=meta)
    hpos = ipos(range(s))
    out["Hymba"] = dict(
        prefill=(rnd(1, s, h, dh), rnd(1, s, kv, dh), rnd(1, s, kv, dh),
                 hpos, hpos, kw),
        decode=(rnd(1, 1, h, dh), [(rnd(1, ring, kv, dh),
                                    rnd(1, ring, kv, dh))
                                   for _ in range(n_rings)],
                ipos([s]), ipos(kpos), kw),
        what=f"B=1, S={s}, {h} q / {kv} KV heads of {dh}, window {win}, "
             f"sink {meta}; a wrapped ring of {ring}")
    return out


def time_attention(dev) -> list[dict]:
    """``flash_attention`` and ``decode_attention`` at StableLM's (2048
    and its 32k cells) and Hymba's shapes (cut on the CPU) beside
    ``F.scaled_dot_product_attention``; the plain prefill is the q-chunked
    form from 8192 positions on (the whole (Sq, Sk) logits of a 32k
    prefill would not fit)."""
    import torch.nn.functional as F
    from ..kernels import ref
    from ..kernels.decode_attention import decode_attention
    from ..kernels.flash_attention import flash_attention
    reps = 3 if dev.type == "cpu" else None

    def heads_first(*xs):
        return [x.transpose(1, 2).contiguous() for x in xs]

    def rot(fn, n):
        turn = [0]

        def call():
            turn[0] = (turn[0] + 1) % n
            return fn(turn[0])
        return call

    rows = []
    for cell, inp in attention_inputs(dev, dev.type == "cpu").items():
        q, k, v, qp, kp, kw = inp["prefill"]
        qt, kt, vt = heads_first(q, k, v)
        sdpa_kw = (dict(is_causal=True) if not kw else dict(
            attn_mask=ref.attention_keep(qp, kp, kw["window"], kw["sink"]),
            enable_gqa=True))
        bnd, by, split_p, how = attention_bound(q, k, qp, kp, kw)
        rows.append(_row(
            "flash_attention", f"{cell}: {inp['what']}", dev,
            _kernel_ms(dev, lambda: flash_attention(q, k, v, qp, kp, **kw),
                       reps or 20),
            time_ms(lambda: ref.flash_attention_chunked_ref(
                q, k, v, qp, kp, **kw), reps or 5, dev),
            bnd, by, how + f"; split-P work {split_p * 1e3:.2f} us",
            "F.scaled_dot_product_attention",
            time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **sdpa_kw), reps or 20, dev)))
        qd, caches, qpd, kpd, kw = inp["decode"]
        n = len(caches)
        qdt = heads_first(qd)[0]
        caches_t = [heads_first(kc, vc) for kc, vc in caches]
        dmask = (dict(attn_mask=ref.attention_keep(
            qpd, kpd, kw["window"], kw["sink"]), enable_gqa=True)
            if kw else {})
        bnd, by, _, how = attention_bound(qd, caches[0][0], qpd, kpd, kw)
        rows.append(_row(
            "decode_attention", f"{cell}: one token over the cache", dev,
            _kernel_ms(dev, rot(lambda i: decode_attention(
                qd, *caches[i], qpd, kpd, **kw), n), reps or 100),
            time_ms(rot(lambda i: ref.decode_attention_ref(
                qd, *caches[i], qpd, kpd, **kw), n), reps or 20, dev),
            bnd, by, how + f"; {n} caches in turn",
            "F.scaled_dot_product_attention",
            time_ms(rot(lambda i: F.scaled_dot_product_attention(
                qdt, *caches_t[i], **dmask), n), reps or 100, dev)))
    return rows


def gla_inputs(g, b, s, h, dk, dv, dt, init: bool, strided: bool = False,
               device="cuda"):
    """GLA inputs: q, k, v in ``dt``, log-sigmoid gates in f32, and an
    initial (S0, n0) or None.  ``strided``: q and k are the two halves of
    one (B,S,H,2dk) tensor, as Mamba's C and B are."""
    import torch.nn.functional as F
    rn = lambda *sh: torch.randn(sh, generator=g, device=device)
    if strided:
        qk = rn(b, s, h, 2 * dk)
        qk[..., dk:] *= 0.3
        q, k = torch.chunk(qk.to(dt), 2, dim=-1)
    else:
        q, k = rn(b, s, h, dk).to(dt), (rn(b, s, h, dk) * 0.3).to(dt)
    v = rn(b, s, h, dv).to(dt)
    log_f, log_i = F.logsigmoid(rn(b, s, h) - 1.0), F.logsigmoid(rn(b, s, h))
    st = (rn(b, h, dk, dv) * 0.1, rn(b, h, dk).abs()) if init else None
    return (q, k, v, log_f, log_i), st


def gla_bound_ms(b, s, h, dk, dv, chunk, elt) -> dict:
    """The least time for one gla_chunk call: the larger of its bytes (q,
    k, v in, y out in the model dtype; f32 gates in, f32 state and
    normaliser out) at 3.35 TB/s and its operations on and below each
    chunk's diagonal (scores, A.v, the decayed state read, the state carry
    and the normaliser's two dot products) at the bf16 tensor rate.
    Beside it, the bf16 route's own floors: its split work (q k^T once;
    A v, q S_in and (k w)^T v twice, as bf16 hi + lo terms) at the bf16
    rate, and its bytes with the scratch round trips (the chunks' own f32
    states, their bf16 hi + lo entering states from chunk 1 on, and the
    f32 scores of the 64 x 64 tiles on and below the diagonal, each
    written once and read once) at 3.35 TB/s."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    flops = b * h * nc * (2 * tri * dk + 2 * tri * dv
                          + 2 * 2 * chunk * dk * dv + 2 * 2 * chunk * dk)
    nbytes = (b * s * h * (2 * dk + 2 * dv) * elt + b * s * h * 2 * 4
              + b * h * (dk * dv + dk) * 4)
    by_ops = flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S
    split = b * h * nc * (2 * tri * dk + 2 * 2 * tri * dv
                          + 2 * 2 * 2 * chunk * dk * dv
                          + 2 * 2 * chunk * dk)
    rt = -(-chunk // 64)
    scratch = b * h * (nc * dk * dv * 4 + (nc - 1) * dk * dv * 4
                       + nc * rt * (rt + 1) // 2 * 64 * 64 * 4)
    design = nbytes + 2 * scratch
    return dict(bound_ms=max(flops / BF16_FLOPS,
                             nbytes / HBM_BYTES_PER_S) * 1e3,
                bound_by="operations" if by_ops else "bytes", flops=flops,
                bytes=nbytes, split_flops=split,
                split_ms=split / BF16_FLOPS * 1e3, design_bytes=design,
                design_ms=max(split / BF16_FLOPS,
                              design / HBM_BYTES_PER_S) * 1e3)


# the main path's GLA shapes: an xLSTM layer's 2048-token prompt (4 heads,
# dk = dv = 512, normalised) and a Hymba layer's 128 + 2048 tokens padded
# to 2304 (25 heads, dk 16, dv 128, not normalised); cut on the CPU
GLA_SHAPES = {"xlstm-350m": (1, 2048, 4, 512, 512, True),
              "hymba-1.5b": (1, 2304, 25, 16, 128, False)}
GLA_SHAPES_CPU = {"xlstm-350m": (1, 256, 2, 64, 64, True),
                  "hymba-1.5b": (1, 256, 3, 16, 32, False)}


def time_gla(dev) -> list[dict]:
    """``gla_chunk`` (chunk 256) at each prefill shape, bf16 on the card
    (f32 and cut on the CPU)."""
    from ..kernels import gla_chunk as gla_mod
    from ..kernels import ref
    cpu = dev.type == "cpu"
    shapes = GLA_SHAPES_CPU if cpu else GLA_SHAPES
    dt = torch.float32 if cpu else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for name, (b, s, h, dk, dv, normalize) in shapes.items():
        args, _ = gla_inputs(g, b, s, h, dk, dv, dt, False, device=dev)
        bd = gla_bound_ms(b, s, h, dk, dv, 256, 4 if cpu else 2)
        how = (f"{bd['flops'] / 1e9:.3f} GFLOP at 989 TFLOP/s vs "
               f"{bd['bytes'] / 1e6:.2f} MB at 3.35 TB/s; split work "
               f"{bd['split_flops'] / 1e9:.3f} GFLOP, "
               f"{bd['split_ms'] * 1e3:.2f} us; with the scratch "
               f"{bd['design_bytes'] / 1e6:.2f} MB, "
               f"{bd['design_ms'] * 1e3:.2f} us")
        if not cpu:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            how += (f"; blocks {gla_mod.tc_blocks(b, s, h, dk, dv, 256)} on "
                    f"{sms} SMs")
        rows.append(_row(
            "gla_chunk", f"{name} prefill: B={b}, S={s}, H={h}, dk={dk}, "
            f"dv={dv}, chunk 256", dev,
            _kernel_ms(dev, lambda: gla_mod.gla_chunk(
                *args, normalize=normalize), 20),
            time_ms(lambda: ref.gla_chunk_plain(*args, normalize=normalize),
                    3 if cpu else 10, dev),
            bd["bound_ms"], bd["bound_by"], how))
    return rows


def run(device=None) -> list[dict]:
    """Every kernel's rows on ``device`` (None: the card; the CPU at small
    shapes)."""
    from .._device import resolve_device
    from .common import write_bench_json
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels import _build
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sizes, reps = (100, N_DEPLOY), 100
    else:
        sizes, reps = (100, 4096), 5
    rows = (time_ranking(dev, sizes, reps)
            + time_lane_scatter(dev, reps=reps)
            + time_point_update(dev, sizes, reps)
            + time_attention(dev) + time_gla(dev))
    write_bench_json("bench_kernels.json", dict(
        benchmark="bench_kernels", device=str(dev), rows=rows))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to time the plain versions on the CPU "
                         "(default: the card)")
    args = ap.parse_args(argv)
    from .common import emit
    emit(run(device=args.device), "bench_kernels")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
