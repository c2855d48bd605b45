#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (any mismatch or fault raises and the script exits non-zero):

0. build every CUDA kernel from src/repro_torch/kernels/csrc (one nvcc per
   source, started together);
1. the simulator's kernels against their plain PyTorch versions on the
   card, bitwise: the ranking kernels at N = 1, 100, 1,025, 2^20,
   1,000,003 and 2^22 + 1 (top 1, 8 and 64, three densities, scores tied
   across tiles), the per-row lane scatter at the main path's stacked
   shapes, and ``lane_scatter_batch`` on random batches (the serve's
   [24, N] f32 + [4, N] bool write, a 9-write eviction batch on [2, N]
   bool, masks, set and add, elements written twice, a target and a view
   of it, batches over the parameter block), one launch a block; then
   CUDA-event timings at the main path's shapes (the ranking kernels at
   N = 100 and 2^20, the serve's write as one batch, as two single
   launches and as ``index_put_``);
2. the paper's result: eq. 17 improvement of the eq.-16 policy over LRU on
   the fig2 synthetic workload through the kernels, held bitwise against
   the same run through the plain versions on the card, plus the card's
   run against the CPU run of a small trace;
3. the state at deployment size: a dense table over 2^20 objects, with the
   kernel path held against the plain path and the ``evict_top=0`` path;
4. the two attention kernels against their plain versions on the card over
   head widths 16/32/64/128 (bf16 takes the tensor-core prefill kernel,
   f32 the CUDA-core one), GQA groups 1/4/12/24, ragged Sq and Sk
   (Sq 17, 31 and 33 against the 16-row mma tile), windows of 4096 (with
   and without a sink) and 32, softcap 0 and 30, a wrapped ring-buffer
   cache with empty slots, decode caches of 1, 63, 65 and 129 slots
   (against the 64-slot split granularity) and of 4300 slots at batch 3
   (dozens of splits), caches with no visible slot, Hymba-1.5B's shapes
   (25 q and 5 KV heads of 64, window 1024 with a 128-token sink, a
   wrapped 1152-slot ring with empty slots), in f32 (max |diff| <= 1e-5)
   and bf16 (at most one bf16 ulp of each output element, plus 1e-5);
   then their times at StableLM-2-1.6B's and Hymba-1.5B's shapes beside
   their bounds, the plain versions and PyTorch's
   ``scaled_dot_product_attention``;
5. the LM serve path at full width: ``stablelm-1.6b`` (24 layers, d 2048,
   bf16, random weights from a seed) behind a ``ContinuousBatcher``
   (max_batch 4, 8 requests of 512-2048 prompt tokens, 32 new tokens
   each) through the kernels, the same requests through the plain
   versions (both after an untimed warm-up of both on the same
   prompts), and an f32 check of prefill and teacher-forced decode logits
   of the kernel path against the plain path;
6. the ``gla_chunk`` kernel against its plain version on the card over
   (dk, dv) in (16, 128), (512, 512), (64, 64), (16, 32), chunks of 16,
   64 and 256 (one and three of them), normalised or not, zero or given
   initial state, contiguous or strided q and k, f32 (the CUDA-core
   kernel) and bf16 (the tensor-core route), and the main path's two
   shapes (y, S and n within atol 1e-4 + rtol 1e-3, bf16 y within one
   more bf16 ulp), the bf16 route's distance to ``ref.gla_chunk_split``
   logged; then its times at xLSTM-350M's and Hymba-1.5B's prefill shapes
   beside the plain version, its bound, its split-work and scratch floors
   and the blocks of its grids;
7. ``xlstm-350m`` (24 mLSTM blocks, d 1024, bf16) at full width behind
   the ``ContinuousBatcher`` as in phase 5, through the kernel (192
   ``gla_chunk`` launches) and its plain version, and the f32 check;
8. ``hymba-1.5b`` (32 blocks, d 1600, bf16) at full width by direct
   prefill and decode calls at ``pos0 = meta + S + i`` (the batcher leaves
   the meta tokens out of its positions, so ``serve`` refuses the
   model): prompts of 1,000 and 2,048 tokens and 16 decode steps each,
   through ``gla_chunk``, ``flash_attention`` and ``decode_attention``
   and through their plain versions (after an untimed warm-up of both),
   and the f32 check.

9. the sweep grid: (a) fig2 through ``repro_torch.figures.
   fig2_synthetic.run`` at ``FIG2_GRID_REQUESTS`` = 10,000 requests
   (cut from fig2's own 30,000: at 30,000 phases 0-10 alone took 949 s
   on an H100 80GB HBM3 at 700 W, and phases 0-12 over 1300 s; 100
   objects, Poisson and Pareto arrivals, C = 500 MB; the 11-policy roster
   with the recency residual and the rate residual's three policies, each
   with its LRU lane) through the kernels and, side by side in a second
   process, through the plain versions, all four grids bit for bit, the
   eq.-16
   Poisson/recency improvement inside 3-30%, every policy's improvement
   printed; (b) lru / vacdh / stoch_vacdh x omega {0.5, 1, 2} x capacity
   {5%, 10%} of the touched footprint over phase 3's 2^20-object
   universe (18 lanes, 943 MB of state) for ``GRID_REQUESTS`` = 5,000
   requests (cut for the host-bound replay rate), kernels against plain
   versions bit for bit, three lanes against single-lane ``simulate``
   calls, with lane-requests/s and syncs per lane-request against the
   18 one-lane runs' wall extrapolated from those three;
10. streaming: ``realworld_raw`` (20,000 requests, cut from
   fig_realworld's 1,000,000 for time; 200,000 keys, epoch times from
   1.7e9 s) compacted as fig_realworld does (top 4096 + a pool of 512,
   capacity 10% of the footprint) and replayed by ``simulate_stream``
   (chunks of 4096, rebased) through the kernels and the plain versions
   bit for bit; ``simulate_chunked`` (4096) against ``simulate`` on
   9(a)'s fig2 Poisson trace (``FIG2_GRID_REQUESTS``), and the chunked
   fig2 Poisson rate grid against 9(a)'s unchunked one;
11. the slot table: phase 10's raw stream with every key its own id
   (``exact_requests``: fig_realworld's exact rows) replayed by
   ``simulate_stream(state_mode="slots")`` over ``slot_table_size(200,000,
   load=0.75)`` = 2^19 slots (chunks of 4096, rebased; the eq.-16 lane
   scored by ``ranking_scores`` over the table, every eviction an argmin
   with the id tie-break) through the kernels and the plain versions,
   and the dense ``evict_top=0`` replay of the same stream, all bit for
   bit; a ``SLOT_PREFIX`` = 5,000-request prefix under hash seeds 0 and 1
   (bit for bit) and through a table of half its keys (reclaim fires),
   kernels against plain versions bit for bit with every request
   counted; one eviction's pick at 2^19 slots, its device kernels
   (``torch.profiler``) and time with the id and the position tie-break;
12. the hierarchy: (a) ``fig6_hierarchy.run`` over its default grid
   (routes hash and random x S 1 and 4, each a grid of 4 hop laws x 3
   policies x L2 0/2000) cut to ``HIER_REQUESTS`` = 5,000 requests, with
   the kernel writes and, side by side in a second process, the plain
   writes, every point bit for bit, the eq.-16 improvement over LRU
   printed per route, S, hop law and L2 capacity; (b) 4 hash-routed L1 shards (stoch_vacdh,
   5% of the touched footprint each) over an LRU L2 (20%), exponential
   hops of mean 0.01 s, over phase 3's 2^20-object universe (5 lanes,
   262 MB of state) for the same 5,000 requests, kernel writes against
   plain writes bit for bit, with req/s and syncs per request;
13. serving: the prefix-cache engine on a 600-request flash crowd on the
   card against the CPU (every counter, the latency sum and the sketch);
   (a) ``bench_serving.run(smoke=True)`` (flash_crowd, degraded_replica
   and origin_outage at 3,000 requests, hedged and not, flash_crowd
   through an L1 + L2, SLO bisections) through the kernels and through
   the plain versions, every row field but ``bench_serving.MEASURED``
   equal, with req/s, syncs per request and ranking and lane-scatter
   launches an admission; (b) flash_crowd at ``SERVE_REQUESTS`` = 20,000
   requests over ``N_KEYS`` keys through a ``SERVE_OBJECTS`` = 2^18-object
   prefix table (25% of the footprint, hedged), eq. 16 (through
   ``ranking_victim_order``) and LRU (its epilogue and a sort on the
   card), kernels against plain versions in every (outcome, latency)
   pair and counter, with req/s, syncs per request and the mirror's
   bytes.  A kernel run must launch ``ranking_victim_order`` at least
   once an eq.-16 admission and the lane scatter at least once a rank.

Each main-path run starts from zeroed launch counts, prints its
lane-scatter launches per request, and must launch every kernel it
reaches (the LM runs: exactly once a layer per prompt or per
decoded token); a run through the plain versions must launch none.

The last line of standard output is ``{"ok": true, "device": {...}}``;
before it come the ``kernels`` JSON line and the card's name and power
limit as nvidia-smi gives them, and each phase's seconds.  With no card
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS = 67e12             # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate
TOP = 8                       # the simulator's EVICT_TOP
N_DEPLOY = 1 << 20            # the million-key universe of probe_memory
GRID_REQUESTS = 5_000         # phase 9b's replay, cut for the host-bound rate
FIG2_GRID_REQUESTS = 10_000   # phases 9a-10's fig2, cut for the time limit
STREAM_REQUESTS = 20_000      # phases 10-11's stream, cut from 1,000,000
N_KEYS = 200_000              # fig_realworld's key space
SLOT_PREFIX = 5_000           # phase 11's seed and reclaim runs
HIER_REQUESTS = 5_000         # phase 12's hierarchies, cut for the host rate


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 100) -> float:
    """Median device time of one ``fn()`` call over ``reps`` calls, from
    CUDA events around each call.  The calls are queued behind a sleep
    kernel, so the host's launch cost does not show in the device time."""
    import torch
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


def bitwise_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def ranking_inputs(n: int, density, seed: int):
    """Eq.-16 inputs on the card; an eighth of the elements repeat other
    elements' inputs exactly, so scores tie across tiles."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g,
                                                   device="cuda")
    lam, z, resid, sizes = u(1e-3, 50.0), u(1e-3, 2.0), u(1e-3, 10.0), \
        u(1.0, 100.0)
    dst = torch.randperm(n, generator=g, device="cuda")[:n // 8]
    src = torch.randperm(n, generator=g, device="cuda")[:n // 8]
    for x in (lam, z, resid, sizes):
        x[dst] = x[src]
    if density == "sparse":          # 2 cached per 1024-tile (< TOP)
        cached = torch.zeros(n, dtype=torch.bool, device="cuda")
        cached[3::1024] = True
        cached[700::1024] = True
    else:
        cached = torch.rand(n, generator=g, device="cuda") < density
    return lam, z, resid, sizes, cached


RANK_NS = (1, 100, 1025, N_DEPLOY, 1_000_003)   # fig2's table is N = 100
RANK_TOPS = (1, TOP, 64)


def check_ranking(err: dict) -> int:
    """Both ranking wrappers against their plain versions, bitwise: every
    N of RANK_NS at omega 0/1/2, densities 0.5/sparse/0 and every top of
    RANK_TOPS, plus 2^22 + 1 objects (three merge levels) at omega 1."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ranking_score import (ranking_scores,
                                                   ranking_victim_order)
    grid = [(n, omega, density) for n in RANK_NS for omega in (0.0, 1.0, 2.0)
            for density in (0.5, "sparse", 0.0)]
    grid += [((1 << 22) + 1, 1.0, density) for density in (0.5, "sparse")]
    cases = 0
    for seed, (n, omega, density) in enumerate(grid):
        args = ranking_inputs(n, density, seed=seed)
        for top in RANK_TOPS:
            f, idx, vals = ranking_victim_order(*args, omega=omega, top=top)
            rf, ridx, rvals = ref.ranking_victim_order_ref(
                *args, omega, min(top, n))
            if not (bitwise_equal(f, rf) and bitwise_equal(idx, ridx)
                    and bitwise_equal(vals, rvals)):
                raise AssertionError(
                    f"ranking_victim_order != plain at n={n} omega={omega} "
                    f"density={density} top={top}: idx {idx.tolist()[:16]} "
                    f"vs {ridx.tolist()[:16]}, vals {vals.tolist()[:16]} "
                    f"vs {rvals.tolist()[:16]}")
            err["ranking_victim_order"] = max(
                err["ranking_victim_order"], float((f - rf).abs().max()))
            cases += 1
        f2, i2, v2 = ranking_scores(*args, omega=omega)
        rf2, ri2, rv2 = ref.ranking_scores_ref(*args, omega)
        if not (bitwise_equal(f2, rf2) and int(i2) == int(ri2)
                and bitwise_equal(v2, rv2)):
            raise AssertionError(
                f"ranking_scores != plain at n={n} omega={omega} "
                f"density={density}: ({int(i2)}, {float(v2)}) vs "
                f"({int(ri2)}, {float(rv2)})")
        err["ranking_scores"] = max(err["ranking_scores"],
                                    float((f2 - rf2).abs().max()))
        cases += 1
    return cases


def batch_writes(rng, targets, n_writes, masked, add, repeat):
    """Random writes (host operands) over ``targets``, round robin; with
    ``repeat`` every other write re-hits half the elements of the previous
    write to the same target."""
    import numpy as np
    import torch
    writes, prev = [], {}
    for k in range(n_writes):
        x = targets[k % len(targets)]
        rows, n = x.shape
        idx = rng.integers(0, n, rows).astype(np.int32)
        if repeat and id(x) in prev and k % 2:
            idx[:rows // 2 + 1] = prev[id(x)][:rows // 2 + 1]
        prev[id(x)] = idx
        if x.dtype == torch.bool:
            val = rng.random(rows) < 0.5
        elif x.dtype == torch.int32:
            val = rng.integers(-1000, 1000, rows).astype(np.int32)
        else:
            val = (rng.standard_normal(rows) * 100).astype(np.float32)
        valid = rng.random(rows) < 0.6 if masked else None
        writes.append((x, idx, val, valid,
                       add if add is not None else bool(k % 2)))
    return writes


def check_lane_batch(err: dict) -> int:
    """``lane_scatter_batch`` against ``lane_scatter_batch_ref``, bitwise,
    with its launches counted against the blocks the batch packs into."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import lane_scatter as ls
    g = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    n = N_DEPLOY

    def state(rows, dtype, width=n):
        if dtype == torch.bool:
            return torch.rand((rows, width), generator=g, device="cuda") < 0.5
        return (torch.randn((rows, width), generator=g, device="cuda")
                * 100).to(dtype)

    cases = 0
    for masked in (False, True):
        for add in (False, True, None):
            for repeat in (False, True):
                vals, flags = state(24, torch.float32), state(4, torch.bool)
                ints, cached = state(8, torch.int32), state(2, torch.bool)
                for what, targets, k in (
                        ("serve [24, N] f32 + [4, N] bool", [vals, flags], 2),
                        ("eviction batch, 9 writes on [2, N] bool",
                         [cached], 9),
                        ("f32 + i32 + bool, 12 writes",
                         [vals, ints, flags], 12),
                        ("[4, N] bool and its first rows as a view",
                         [flags, flags[:2]], 6),
                        ("240 writes on [24, N] f32 (over a block)",
                         [vals], 240)):
                    writes = batch_writes(rng, targets, k, masked, add,
                                          repeat)
                    want = {id(x): x.clone() for x in (vals, flags, ints,
                                                       cached)}
                    ref.lane_scatter_batch_ref(
                        [(want[id(x)] if id(x) in want
                          else want[id(flags)][:2], *w) for x, *w in writes])
                    before = ls.launches["lane_scatter"]
                    ls.lane_scatter_batch(writes)
                    got_n = ls.launches["lane_scatter"] - before
                    blocks = len(ls.pack(ls._prepare(writes)[1]))
                    if got_n != blocks:
                        raise AssertionError(f"{what}: {got_n} launches for "
                                             f"{blocks} blocks")
                    for x in (vals, flags, ints, cached):
                        if not bitwise_equal(x, want[id(x)]):
                            raise AssertionError(
                                f"lane_scatter_batch != plain: {what}, "
                                f"masked={masked} add={add} "
                                f"repeat={repeat}")
                    cases += 1
    # one write of more rows than a block holds: cut by rows
    big = state(5000, torch.float32, 64)
    writes = batch_writes(rng, [big], 3, True, None, True)
    want = big.clone()
    ref.lane_scatter_batch_ref([(want, *w) for _, *w in writes])
    ls.lane_scatter_batch(writes)
    if not bitwise_equal(big, want):
        raise AssertionError("lane_scatter_batch != plain: [5000, 64] rows")
    cases += 1
    return cases


def phase_kernels() -> dict:
    """Every simulator kernel against its plain version; timings at the
    main path's shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.lane_scatter import (lane_scatter_add,
                                                  lane_scatter_batch,
                                                  lane_scatter_set)
    from repro_torch.kernels.ranking_score import (ranking_scores,
                                                   ranking_victim_order)
    err = {"ranking_victim_order": 0.0, "ranking_scores": 0.0,
           "lane_scatter": 0.0}
    cases = check_ranking(err)
    log(f"phase 1: ranking kernels bitwise equal to plain over {cases} "
        f"cases (n in {', '.join(map(str, RANK_NS))}, 2^22+1; omega "
        f"0/1/2; density 0.5/sparse/0; top {'/'.join(map(str, RANK_TOPS))}"
        f" and the argmin; scores tied across tiles)")

    g = torch.Generator(device="cuda").manual_seed(99)
    lane_cases = 0
    # 12 and 24 rows are the main path's stacked f32 fields (1 and 2
    # lanes), 2 and 4 rows its stacked bool fields
    for lanes in (1, 2, 4, 8, 12, 24):
        for dtype in (torch.float32, torch.int32, torch.bool):
            for add in (False, True):
                for masked in (False, True):
                    n = N_DEPLOY
                    if dtype == torch.bool:
                        x = torch.rand((lanes, n), generator=g,
                                       device="cuda") < 0.5
                        val = torch.rand(lanes, generator=g,
                                         device="cuda") < 0.5
                    else:
                        x = (torch.randn((lanes, n), generator=g,
                                         device="cuda") * 100).to(dtype)
                        val = (torch.randn(lanes, generator=g,
                                           device="cuda") * 100).to(dtype)
                    idx = torch.randint(0, n, (lanes,), generator=g,
                                        device="cuda", dtype=torch.int32)
                    if lanes > 1:
                        idx[1] = idx[0]       # two lanes, one column
                    valid = (torch.rand(lanes, generator=g, device="cuda")
                             < 0.5) if masked else None
                    fn = lane_scatter_add if add else lane_scatter_set
                    rfn = ref.lane_scatter_add_ref if add \
                        else ref.lane_scatter_set_ref
                    got = fn(x.clone(), idx, val, valid)
                    want = rfn(x.clone(), idx, val, valid)
                    if not bitwise_equal(got, want):
                        raise AssertionError(
                            f"lane_scatter != plain: L={lanes} {dtype} "
                            f"add={add} masked={masked}")
                    lane_cases += 1
    log(f"phase 1: lane_scatter bitwise equal to plain over {lane_cases} "
        f"cases (L 1/2/4/8/12/24; f32/i32/bool; set/add; masked or "
        f"not)")
    batch_cases = check_lane_batch(err)
    log(f"phase 1: lane_scatter_batch bitwise equal to plain over "
        f"{batch_cases} batches (serve [24, N] f32 + [4, N] bool; 9 "
        f"eviction writes on [2, N] bool; f32 + i32 + bool; a target and a "
        f"view of it; 240 writes over a parameter block; one write of 5000 "
        f"rows; masked or not; set, add or both; elements written twice "
        f"or not), one launch a block")

    # --- timings at the main path's shapes --------------------------------
    n = N_DEPLOY
    t = {}
    for n_r in (100, N_DEPLOY):
        args = ranking_inputs(n_r, 0.5, seed=1234)
        bound = max(n_r * (4 * 4 + 1 + 4) / HBM_BYTES_PER_S,
                    n_r * 16 / F32_FLOPS) * 1e3
        t[("ranking_victim_order", n_r)] = (
            time_ms(lambda: ranking_victim_order(*args, omega=1.0, top=TOP)),
            time_ms(lambda: ref.ranking_victim_order_ref(*args, 1.0, TOP)),
            bound + (TOP * 8) / HBM_BYTES_PER_S * 1e3, None)
        t[("ranking_scores", n_r)] = (
            time_ms(lambda: ranking_scores(*args, omega=1.0)),
            time_ms(lambda: ref.ranking_scores_ref(*args, 1.0)),
            bound + 8 / HBM_BYTES_PER_S * 1e3, None)
    # the serve's write: 12 f32 fields x 2 lanes and 2 flags x 2 lanes, as
    # one batch (over fig2's 100 objects and over 2^20), as two single
    # launches and as index_put_ (over 2^20)
    rng = np.random.default_rng(7)

    def serve_write(n_w):
        vals = torch.zeros((24, n_w), dtype=torch.float32, device="cuda")
        flags = torch.zeros((4, n_w), dtype=torch.bool, device="cuda")
        return [(vals, rng.integers(0, n_w, 24), rng.random(24, np.float32),
                 None, False),
                (flags, rng.integers(0, n_w, 4), rng.random(4) < 0.5, None,
                 False)]

    # bytes: each row's index and value read, its element written
    write_bound = (24 * (4 + 4 + 4) + 4 * (4 + 4 + 1)) / HBM_BYTES_PER_S * 1e3
    fig2_write = serve_write(100)
    t[("lane_scatter", 100)] = (
        time_ms(lambda: lane_scatter_batch(fig2_write)),
        time_ms(lambda: ref.lane_scatter_batch_ref(fig2_write)),
        write_bound, None)
    serve = serve_write(n)
    dev_ops = [(x, torch.as_tensor(i, dtype=torch.int32, device="cuda"),
                torch.as_tensor(v, device="cuda"),
                torch.arange(x.shape[0], device="cuda"))
               for x, i, v, _, _ in serve]

    def singles():
        for x, i, v, _ in dev_ops:
            lane_scatter_set(x, i, v)

    def library():
        for x, i, v, rows in dev_ops:
            x.index_put_((rows, i.long()), v)

    t[("lane_scatter", n)] = (
        time_ms(lambda: lane_scatter_batch(serve)),
        time_ms(lambda: ref.lane_scatter_batch_ref(serve)), write_bound,
        time_ms(library))
    single_ms = time_ms(singles)
    # the same write in the 32 KB parameter variant: 130 skipped rows of
    # padding make the block too large for the 512 B one
    pad = torch.zeros((130, 1), device="cuda")
    padded = serve + [(pad, np.full(130, -1), np.zeros(130, np.float32),
                       None, False)]
    padded_ms = time_ms(lambda: lane_scatter_batch(padded))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        lane_scatter_batch(serve)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) * 1e3
    for (k, n_k), (ms, plain, bound, lib) in t.items():
        at = ("the serve's write, " if k == "lane_scatter" else "") + \
            f"N={n_k}"
        log(f"phase 1: {k} at {at}: {ms * 1e3:.2f} us/launch, plain "
            f"{plain * 1e3:.2f} us, bound {bound * 1e3:.4f} us"
            + ("" if lib is None else
               f", library {lib * 1e3:.2f} us (2 x index_put_)"))
    log(f"phase 1: lane_scatter at the serve's write, N={n}: two single "
        f"launches {single_ms * 1e3:.2f} us; in the 32 KB parameter block "
        f"{padded_ms * 1e3:.2f} us; one batch call {host_us:.2f} us on the "
        f"host clock (packing + launch, 1000 calls)")
    return {k: dict(ms=v[0], plain_ms=v[1], bound_ms=v[2], library_ms=v[3],
                    max_abs_err=err[k])
            for (k, n_k), v in t.items() if n_k == N_DEPLOY}


def same_result(a, b) -> bool:
    return all(float(getattr(a, f)) == float(getattr(b, f))
               for f in ("total_latency", "n_hits", "n_delayed", "n_misses",
                         "n_evictions"))


def drive(label, fn, needs=()):
    """One run of a path from zeroed launch counts; ``needs`` names the
    kernels the run must launch (an empty tuple: the run must launch
    none).  Returns the path's output, its counters and its launch
    counts."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    counts = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(counts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lc = launch_counts()
    lanes = (f"{counts['lane_requests'] / dt:.1f} lane-requests/s, "
             f"{counts['syncs'] / counts['lane_requests']:.4f} syncs/"
             f"lane-request, " if "lane_requests" in counts else "")
    log(f"{label}: {dt:.2f} s, {counts['requests'] / dt:.1f} req/s, {lanes}"
        f"{counts['syncs'] / counts['requests']:.3f} syncs/request, "
        f"{counts['scoring_commits']} scoring commits, "
        f"{lc['lane_scatter'] / counts['requests']:.3f} lane_scatter "
        f"launches/request, launches {lc}")
    for k in needs:
        if lc[k] <= 0:
            raise AssertionError(f"{label} did not launch {k}")
    if not needs and any(lc.values()):
        raise AssertionError(f"{label} launched kernels: {lc}")
    return out, counts, lc


def add_launches(total: dict, lc: dict) -> None:
    for k, v in lc.items():
        total[k] = total.get(k, 0) + v


def phase_paper(launches: dict) -> None:
    """Eq. 17 on the fig2 workload, kernels against plain versions; the
    card against the CPU on a small trace."""
    import torch
    from repro_torch.core import PolicyParams, latency_improvement, simulate
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace

    small = SyntheticSpec(n_objects=60, n_requests=2000, rate=500.0,
                          latency_base=0.01, latency_per_mb=1e-3)
    tr = synthetic_trace(torch.Generator().manual_seed(2), small,
                         device="cpu")
    for policy in ("stoch_vacdh", "lru", "lru_mad"):
        on_card = simulate(tr, 200.0, policy, estimate_z=True)
        on_cpu = simulate(tr, 200.0, policy, estimate_z=True, device="cpu")
        if not same_result(on_card, on_cpu):
            raise AssertionError(f"{policy}: card {on_card} != cpu {on_cpu}")
    log("phase 2: small trace (60 objects, 2000 requests): card == CPU for "
        "stoch_vacdh, lru, lru_mad")

    spec = SyntheticSpec(n_objects=100, n_requests=30_000, zipf_alpha=0.9,
                         rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(0), spec)
    params = PolicyParams(omega=1.0, resid="recency")
    runs = {}
    for mode, needs in ((True, ("ranking_victim_order", "lane_scatter")),
                        ("ref", ())):
        runs[mode] = drive(
            f"phase 2: fig2 latency_improvement(use_kernel={mode!r})",
            lambda c, mode=mode: latency_improvement(
                tr, 500.0, "stoch_vacdh", "lru", params=params,
                estimate_z=True, use_kernel=mode, counters=c),
            needs)
    (impr, counts, lc), (plain, plain_counts, _) = runs[True], runs["ref"]
    add_launches(launches, lc)
    if not (bitwise_equal(impr, plain) and counts == plain_counts):
        raise AssertionError(f"fig2: kernels {float(impr)} {counts} != "
                             f"plain {float(plain)} {plain_counts}")
    impr = float(impr)
    log(f"phase 2: fig2 workload (100 objects, 30000 requests, C=500 MB): "
        f"improvement over LRU {impr * 100:.3f}% (paper band 3-30%), "
        f"kernels == plain bitwise")
    if not 0.03 <= impr <= 0.30:
        raise AssertionError(f"improvement {impr} outside the 3-30% band")


def phase_deploy(n_requests: int, launches: dict) -> None:
    """Dense state over 2^20 objects on the card; kernel path vs plain."""
    import torch
    from repro_torch.core import (PolicyParams, latency_improvement,
                                  simulate)
    from repro_torch.core.state import F32_FIELDS
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace

    spec = SyntheticSpec(n_objects=N_DEPLOY, n_requests=n_requests,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(7), spec)
    touched = torch.unique(tr.objs.long())
    capacity = float(0.1 * tr.sizes[touched].sum())
    state_mb = (len(F32_FIELDS) * 4 + 2) * N_DEPLOY / 1e6
    log(f"phase 3: {N_DEPLOY} objects ({state_mb:.1f} MB of state a lane), "
        f"{n_requests} requests, {touched.numel()} objects touched, "
        f"capacity {capacity:.1f} MB")
    params = PolicyParams(omega=1.0, resid="recency")

    def sim(use_kernel, evict_top=None):
        return lambda c: simulate(tr, capacity, "stoch_vacdh", params,
                                  estimate_z=True, use_kernel=use_kernel,
                                  evict_top=evict_top, counters=c)

    kern, _, lc = drive("phase 3: simulate(kernels)", sim(True),
                        ("ranking_victim_order", "lane_scatter"))
    add_launches(launches, lc)
    plain, _, _ = drive("phase 3: simulate(plain versions)", sim("ref"))
    if not same_result(kern, plain):
        raise AssertionError(f"kernel path {kern} != plain path {plain}")
    log(f"phase 3: kernel == plain: latency {float(kern.total_latency)}, "
        f"hits {int(kern.n_hits)}, delayed {int(kern.n_delayed)}, misses "
        f"{int(kern.n_misses)}, evictions {int(kern.n_evictions)}")
    top0, _, lc = drive("phase 3: simulate(kernels, evict_top=0)",
                        sim(True, 0), ("ranking_scores", "lane_scatter"))
    add_launches(launches, lc)
    if not same_result(kern, top0):
        raise AssertionError(f"evict_top=0 {top0} != evict_top=8 {kern}")
    log("phase 3: evict_top=0 == evict_top=8, every counter and the "
        "latency bit")

    impr, _, lc = drive(
        "phase 3: latency_improvement(kernels)",
        lambda c: latency_improvement(tr, capacity, "stoch_vacdh", "lru",
                                      params, estimate_z=True,
                                      use_kernel=True, counters=c),
        ("ranking_victim_order", "lane_scatter"))
    add_launches(launches, lc)
    if not torch.isfinite(impr):
        raise AssertionError(f"improvement {impr} is not finite")
    log(f"phase 3: improvement over LRU {float(impr) * 100:.3f}%")


# --- phases 4-5: the LM serve path --------------------------------------------
SERVE_ARCH = "stablelm-1.6b"


def bf16_ulp_excess(got, want):
    """Largest ``(|got - want| - 1e-5) / ulp`` over the elements, with
    ``ulp`` one bf16 ulp at the larger of the two magnitudes (<= 1
    passes).  Kernel and plain version round f32 results that differ by
    at most the f32 tolerance (1e-5) once to bf16, so they differ by at
    most one bf16 ulp plus that: near zero, where a bf16 ulp is finer than
    the f32 difference, the 1e-5 term is what remains."""
    import torch
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    _, e = torch.frexp(mag)                 # mag = m * 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return float((((g - w).abs() - 1e-5) / ulp).max())


def phase_attention() -> dict:
    """Both attention kernels against their plain versions over the sweep;
    timings at StableLM-2-1.6B's and Hymba-1.5B's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_splits, q_tile)
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    def ipos(a):
        return torch.as_tensor(a, dtype=torch.int32, device="cuda")

    worst = {}                    # (kernel, dtype) -> (abs err, ulp excess)

    def check(name, dt, got, want, what):
        err = float((got.float() - want.float()).abs().max())
        ulps = bf16_ulp_excess(got, want) if dt == "bf16" else 0.0
        ok = err <= 1e-5 if dt == "f32" else ulps <= 1.0
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} != plain ({dt}, {what}): max "
                                 f"|diff| {err}, {ulps} bf16 ulp")
        e0, u0 = worst.get((name, dt), (0.0, 0.0))
        worst[(name, dt)] = (max(e0, err), max(u0, ulps))

    cases = 0
    for dt, tdt in dts.items():
        for dh in (16, 32, 64, 128):
            for h, kv in ((4, 4), (8, 2), (12, 1), (24, 1)):
                for b, sq, sk in ((2, 100, 100), (1, 130, 300)):
                    q, k, v = (rnd((b, sq, h, dh), tdt),
                               rnd((b, sk, kv, dh), tdt),
                               rnd((b, sk, kv, dh), tdt))
                    qp, kp = ipos(range(sk - sq, sk)), ipos(range(sk))
                    for w, cap, sink in ((0, 0.0, 0), (32, 0.0, 8),
                                         (32, 30.0, 0), (0, 30.0, 0)):
                        kw = dict(window=w, softcap=cap, sink=sink)
                        check("flash_attention", dt,
                              flash_attention(q, k, v, qp, kp, **kw),
                              ref.flash_attention_ref(q, k, v, qp, kp, **kw),
                              f"dh={dh} H={h} KV={kv} B={b} Sq={sq} "
                              f"Sk={sk} {kw}")
                        cases += 1
                # decode: a wrapped ring buffer (positions out of order,
                # the last 30 slots empty) of 300 slots
                sc = 300
                kpos = [(i * 7) % (sc - 30) + 40 if i < sc - 30 else -1
                        for i in range(sc)]
                q, k, v = (rnd((3, 1, h, dh), tdt), rnd((3, sc, kv, dh), tdt),
                           rnd((3, sc, kv, dh), tdt))
                qp, kp = ipos([sc + 9]), ipos(kpos)
                for w, cap, sink in ((0, 0.0, 0), (64, 0.0, 4),
                                     (64, 30.0, 0), (0, 30.0, 0)):
                    kw = dict(window=w, softcap=cap, sink=sink)
                    check("decode_attention", dt,
                          decode_attention(q, k, v, qp, kp, **kw),
                          ref.decode_attention_ref(q, k, v, qp, kp, **kw),
                          f"dh={dh} H={h} KV={kv} ring {sc} {kw}")
                    cases += 1
        # the 4096 window (StarCoder2's), with and without a sink, past
        # its length: prefill and decode
        for dh in (64, 128):
            b, s, h, kv = 1, 4300, 8, 2
            q, k, v = (rnd((b, s, h, dh), tdt), rnd((b, s, kv, dh), tdt),
                       rnd((b, s, kv, dh), tdt))
            pos = ipos(range(s))
            for sink in (0, 16):
                kw = dict(window=4096, softcap=0.0, sink=sink)
                check("flash_attention", dt,
                      flash_attention(q, k, v, pos, pos, **kw),
                      ref.flash_attention_ref(q, k, v, pos, pos, **kw),
                      f"dh={dh} S={s} {kw}")
                check("decode_attention", dt,
                      decode_attention(q[:, -1:], k, v, pos[-1:], pos, **kw),
                      ref.decode_attention_ref(q[:, -1:], k, v, pos[-1:],
                                               pos, **kw),
                      f"dh={dh} Sc={s} {kw}")
                cases += 2
    # edges of the two designs: Sq ragged against the 16-row mma tile;
    # caches of 1, 63, 65 and 129 slots against the 64-slot split
    # granularity (65: a last split of one slot), 4300 slots at batch 3
    # (dozens of splits), the last splits empty, and no visible slot
    for dt, tdt in dts.items():
        for dh in (16, 32, 64, 128):
            h, kv = 8, 2
            for sq, sk in ((17, 17), (31, 95), (33, 200)):
                q, k, v = (rnd((2, sq, h, dh), tdt), rnd((2, sk, kv, dh), tdt),
                           rnd((2, sk, kv, dh), tdt))
                qp, kp = ipos(range(sk - sq, sk)), ipos(range(sk))
                check("flash_attention", dt,
                      flash_attention(q, k, v, qp, kp, window=16, sink=2),
                      ref.flash_attention_ref(q, k, v, qp, kp, window=16,
                                              sink=2),
                      f"dh={dh} Sq={sq} Sk={sk} window 16, sink 2")
                cases += 1
            for b, sc in ((2, 1), (2, 63), (2, 65), (1, 129), (3, 4300)):
                q, k, v = (rnd((b, 1, h, dh), tdt), rnd((b, sc, kv, dh), tdt),
                           rnd((b, sc, kv, dh), tdt))
                tail = ipos([i if i < sc - sc // 3 else -1 for i in range(sc)])
                for qp, kp, what in ((ipos([sc - 1]), ipos(range(sc)), "full"),
                                     (ipos([sc]), tail, "last third empty"),
                                     (ipos([0]), ipos([i + 1 for i in
                                                       range(sc)]),
                                      "no visible slot")):
                    check("decode_attention", dt,
                          decode_attention(q, k, v, qp, kp),
                          ref.decode_attention_ref(q, k, v, qp, kp),
                          f"dh={dh} B={b} Sc={sc} {what}")
                    cases += 1
    # Hymba-1.5B's shapes (25 q heads and 5 KV heads of 64, window 1024
    # with a 128-token sink): prefill over 128 meta + 2048 prompt tokens,
    # and decode over a wrapped 1152-slot ring (sink slots in place, ring
    # slots holding positions out of order) with empty slots
    h, kv, dh, meta, win = 25, 5, 64, 128, 1024
    s = meta + 2048
    ring = meta + win
    kpos = [i if i < meta else meta + (s - meta - win)
            + ((i - meta) + 300) % win for i in range(ring)]
    for i in range(meta + 7, ring, 97):
        kpos[i] = -1                       # slots not written yet
    for dt, tdt in dts.items():
        q, k, v = (rnd((1, s, h, dh), tdt), rnd((1, s, kv, dh), tdt),
                   rnd((1, s, kv, dh), tdt))
        pos = ipos(range(s))
        kw = dict(window=win, softcap=0.0, sink=meta)
        check("flash_attention", dt, flash_attention(q, k, v, pos, pos, **kw),
              ref.flash_attention_ref(q, k, v, pos, pos, **kw),
              f"Hymba prefill S={s} H={h} KV={kv} {kw}")
        qd, kc, vc = (rnd((1, 1, h, dh), tdt), rnd((1, ring, kv, dh), tdt),
                      rnd((1, ring, kv, dh), tdt))
        qpd, kp = ipos([s]), ipos(kpos)
        check("decode_attention", dt,
              decode_attention(qd, kc, vc, qpd, kp, **kw),
              ref.decode_attention_ref(qd, kc, vc, qpd, kp, **kw),
              f"Hymba decode ring {ring} H={h} KV={kv} {kw}")
        cases += 2
    # timed below: the bf16 tensors, 40 rings (59 MB, out of L2 in turn)
    hy_pre = (q, k, v, pos, pos, kw)
    hy_rings = [(kc, vc)] + [(rnd((1, ring, kv, dh), tdt),
                              rnd((1, ring, kv, dh), tdt)) for _ in range(39)]
    hy_dec = (qd, qpd, kp, kw)
    # StableLM-2-1.6B's shapes on the main path (bf16, B=1, 32 MHA heads of
    # 64): causal prefill at S=2048, and decode over a full cache of 2048
    # (4 caches, 67 MB, taken in turn when timed below, so each call finds
    # its cache out of the 50 MB L2, as a layer of the model does)
    b, s, h, dh = 1, 2048, 32, 64
    q, k, v = (rnd((b, s, h, dh), torch.bfloat16) for _ in range(3))
    pos = ipos(range(s))
    caches = [(rnd((b, s, h, dh), torch.bfloat16),
               rnd((b, s, h, dh), torch.bfloat16)) for _ in range(4)]
    qd = rnd((b, 1, h, dh), torch.bfloat16)
    qpd = ipos([s - 1])
    check("flash_attention", "bf16", flash_attention(q, k, v, pos, pos),
          ref.flash_attention_ref(q, k, v, pos, pos),
          f"StableLM prefill S={s} H={h} dh={dh}")
    check("decode_attention", "bf16",
          decode_attention(qd, *caches[0], qpd, pos),
          ref.decode_attention_ref(qd, *caches[0], qpd, pos),
          f"StableLM decode Sc={s} H={h} dh={dh}")
    # as the served cache is: sized prompt + max_new + 1, its tail empty
    kpart = torch.where(pos < s - 33, pos, -1)
    check("decode_attention", "bf16",
          decode_attention(qd, *caches[1], qpd - 33, kpart),
          ref.decode_attention_ref(qd, *caches[1], qpd - 33, kpart),
          f"StableLM decode Sc={s} H={h} dh={dh}, last 33 slots empty")
    cases += 3
    torch.cuda.synchronize()
    for (name, dt), (err, ulps) in sorted(worst.items()):
        log(f"phase 4: {name} {dt}: max |diff| {err:.3e}"
            + (f" ({ulps:.2f} bf16 ulp)" if dt == "bf16" else ""))
    log(f"phase 4: attention kernels == plain within tolerance over "
        f"{cases} cases (f32 <= 1e-5; bf16 <= 1 ulp + 1e-5)")

    # --- timings at StableLM-2-1.6B's and Hymba-1.5B's shapes (bf16) -------
    def bound(q, k, q_pos, k_pos, kw):
        """The least time of one call, the larger of its operations (q.k
        and p.v over the visible pairs) at the bf16 tensor rate and its
        bytes (q, k, v, out and the positions, each once) at 3.35 TB/s;
        also the operations of the tensor-core kernel's split-P work (p.v
        twice: p as bf16 hi + lo)."""
        b, sq, h, dh = q.shape
        sk, kv = k.shape[1], k.shape[2]
        pairs = int(ref.attention_keep(q_pos, k_pos, kw["window"],
                                       kw["sink"]).sum()) * b * h
        flops = 2 * 2 * pairs * dh
        nbytes = (2 * b * sq * h + 2 * b * sk * kv) * dh * q.element_size() \
            + (sq + sk) * 4
        ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S \
            * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms > bytes_ms else "bytes",
                1.5 * flops / BF16_FLOPS * 1e3)

    def heads_first(*xs):
        return [x.transpose(1, 2).contiguous() for x in xs]

    def rot(fn, n):
        turn = [0]

        def call():
            turn[0] = (turn[0] + 1) % n
            return fn(turn[0])
        return call

    kw0 = dict(window=0, sink=0)
    qt, kt, vt = heads_first(q, k, v)
    hq, hk, hv, hpos, _, hkw = hy_pre
    hmask = ref.attention_keep(hpos, hpos, hkw["window"], hkw["sink"])
    hqt, hkt, hvt = heads_first(hq, hk, hv)
    hqd, hqpd, hkp, _ = hy_dec
    hdmask = ref.attention_keep(hqpd, hkp, hkw["window"], hkw["sink"])
    hqdt = heads_first(hqd)[0]
    hrings_t = [heads_first(kc, vc) for kc, vc in hy_rings]
    caches_t = [heads_first(kc, vc) for kc, vc in caches]
    qdt = heads_first(qd)[0]
    nr = len(hy_rings)
    t = {
        ("flash_attention", "StableLM"): (
            time_ms(lambda: flash_attention(q, k, v, pos, pos), 20),
            time_ms(lambda: ref.flash_attention_ref(q, k, v, pos, pos), 5),
            bound(q, k, pos, pos, kw0),
            time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 20),
            "B=1, S=2048, 32 heads of 64, causal"),
        ("flash_attention", "Hymba"): (
            time_ms(lambda: flash_attention(hq, hk, hv, hpos, hpos, **hkw),
                    20),
            time_ms(lambda: ref.flash_attention_ref(hq, hk, hv, hpos, hpos,
                                                    **hkw), 5),
            bound(hq, hk, hpos, hpos, hkw),
            time_ms(lambda: F.scaled_dot_product_attention(
                hqt, hkt, hvt, attn_mask=hmask, enable_gqa=True), 20),
            "B=1, S=2176, 25 q / 5 KV heads of 64, window 1024, sink 128"),
        ("decode_attention", "StableLM"): (
            time_ms(rot(lambda i: decode_attention(qd, *caches[i], qpd, pos),
                        4)),
            time_ms(rot(lambda i: ref.decode_attention_ref(
                qd, *caches[i], qpd, pos), 4), 20),
            bound(qd, caches[0][0], qpd, pos, kw0),
            time_ms(rot(lambda i: F.scaled_dot_product_attention(
                qdt, *caches_t[i]), 4)),
            "B=1, Sc=2048, 32 heads of 64"),
        ("decode_attention", "Hymba"): (
            time_ms(rot(lambda i: decode_attention(
                hqd, *hy_rings[i], hqpd, hkp, **hkw), nr)),
            time_ms(rot(lambda i: ref.decode_attention_ref(
                hqd, *hy_rings[i], hqpd, hkp, **hkw), nr), 20),
            bound(hqd, hy_rings[0][0], hqpd, hkp, hkw),
            time_ms(rot(lambda i: F.scaled_dot_product_attention(
                hqdt, *hrings_t[i], attn_mask=hdmask, enable_gqa=True), nr)),
            "B=1, wrapped ring of 1152, 25 q / 5 KV heads of 64"),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (name, cell), (ms, plain, (bnd, by, split_p), lib, shape) in \
            t.items():
        extra = (f", split-P work bound {split_p * 1e3:.2f} us"
                 if name == "flash_attention" else "")
        log(f"phase 4: {name} at {cell}'s shape ({shape}, bf16): "
            f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, bound "
            f"{bnd * 1e3:.2f} us ({by}){extra}, "
            f"scaled_dot_product_attention {lib * 1e3:.2f} us")
    for cell, (qq, kk) in (("StableLM", (qd, caches[0][0])),
                           ("Hymba", (hqd, hy_rings[0][0]))):
        group = qq.shape[2] // kk.shape[2]
        tiles = kk.shape[2] * -(-group // q_tile(group))
        n_split, split_len = decode_splits(kk.shape[1], tiles, sms)
        log(f"phase 4: decode_attention at {cell}'s shape: {n_split} "
            f"splits of {split_len} slots, {tiles * n_split} blocks on "
            f"{sms} SMs")
    return {name: dict(ms=ms, plain_ms=plain, bound_ms=bnd, library_ms=lib,
                       bound_by=by,
                       max_abs_err=max(worst[(name, d)][0] for d in dts))
            for (name, cell), (ms, plain, (bnd, by, _), lib, _) in t.items()
            if cell == "StableLM"}


def to_f32(t):
    """A parameter tree (dicts and lists of tensors) in f32."""
    if isinstance(t, dict):
        return {k: to_f32(v) for k, v in t.items()}
    return [to_f32(v) for v in t] if isinstance(t, list) else t.float()


def run_request(cfg, params, prompt, steps: int, feed=None):
    """Prefill ``prompt``, then ``steps`` decode steps at
    ``pos0 = meta + S + j`` (forward's contract), fed greedily or with the
    tokens ``feed``; returns (last logits of every step ``[steps+1, V]``,
    the fed tokens, prefill seconds, decode seconds), each phase ending in a
    device sync."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import make_serve_steps
    prefill, decode = make_serve_steps(cfg)
    toks = torch.as_tensor(prompt[None, :], device="cuda")
    s = cfg.meta_tokens + toks.shape[1]
    cache = tf.init_cache(cfg, 1, s + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, {"tokens": toks})
    outs = [logits[0, -1]]
    fed = [int(torch.argmax(logits[0, -1]))] if feed is None else feed
    t1 = time.perf_counter()
    for j in range(steps):
        tok = torch.tensor([[fed[j]]], device="cuda")
        logits, cache = decode(params, cache, tokens=tok, pos0=s + j)
        outs.append(logits[0, -1])
        if feed is None:
            fed.append(int(torch.argmax(logits[0, -1])))
    torch.cuda.synchronize()
    return torch.stack(outs), fed, t1 - t0, time.perf_counter() - t1


def check_f32(phase: int, cfg, params, prompts, steps: int = 16) -> None:
    """f32 at full width: prefill and ``steps`` teacher-forced decode
    logits of the kernel path within 1e-3 of max |logit| of the plain
    path."""
    import dataclasses
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = to_f32(params)
    worst = 0.0
    for i, prompt in enumerate(prompts):
        want, feed, _, _ = run_request(
            dataclasses.replace(cfg32, use_kernel="ref"), p32, prompt, steps)
        got, _, _, _ = run_request(
            dataclasses.replace(cfg32, use_kernel=True), p32, prompt, steps,
            feed)
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        log(f"phase {phase}: f32 prompt {i} ({len(prompt)} tokens): prefill "
            f"+ {steps} teacher-forced decode logits, kernels vs plain: max "
            f"|diff| / max |logit| = {rel:.3e}")
        if not rel <= 1e-3 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"f32 logits of the kernel path differ from "
                                 f"the plain path by {rel} of max |logit|")
    log(f"phase {phase}: f32 full-width check passed (max {worst:.3e} <= "
        f"1e-3 of max |logit|)")


def build_model(phase: int, arch: str):
    import torch
    from repro_torch.launch.serve import build
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    cfg, params = build(arch)
    torch.cuda.synchronize()
    n = tf.n_params(params)
    log(f"phase {phase}: {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"family {cfg.family}, vocab {cfg.vocab}, {n / 1e9:.3f} B parameters "
        f"(cfg.n_params() {cfg.n_params() / 1e9:.3f} B), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    if n != cfg.n_params():
        raise AssertionError(f"{n} parameters, the config says "
                             f"{cfg.n_params()}")
    return cfg, params


def phase_serve(phase: int, arch: str, launches: dict,
                per_prompt: tuple, per_token: tuple) -> None:
    """``arch`` at full width behind the continuous batcher (max_batch 4,
    8 requests of 512-2048 prompt tokens, 32 new tokens each), through the
    kernels and through their plain versions; then the f32 logits check.
    The kernel run must launch each kernel of ``per_prompt`` once a layer
    per prompt and each of ``per_token`` once a layer per decoded token."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import random_prompts, serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = build_model(phase, arch)
    prompts = random_prompts(cfg, 8, 512, 2049)
    max_new = 32
    log(f"phase {phase}: 8 requests, prompt lengths "
        f"{[len(p) for p in prompts]}, {max_new} new tokens each, "
        f"max_batch 4")
    want = {k: cfg.n_layers * len(prompts) for k in per_prompt}
    want.update({k: cfg.n_layers * len(prompts) * (max_new - 1)
                 for k in per_token})
    # untimed warm-up of both paths on the same prompts (2 new tokens), so
    # neither timed run pays first-use costs (library heuristics, memory)
    for mode in (True, "ref"):
        serve(dataclasses.replace(cfg, use_kernel=mode), params, prompts, 2)
    runs = {}
    for mode in (True, "ref"):
        c = dataclasses.replace(cfg, use_kernel=mode)
        reset_launch_counts()
        torch.cuda.synchronize()
        r = serve(c, params, prompts, max_new)
        lc = launch_counts()
        runs[mode] = r
        log(f"phase {phase}: serve(use_kernel={mode!r}): {r['done']} "
            f"requests, prefill {r['prefill_tokens']} tokens in "
            f"{r['prefill_s']:.3f} s "
            f"({r['prefill_tokens'] / r['prefill_s']:.1f} tok/s), decode "
            f"{r['decode_tokens']} tokens in {r['decode_s']:.3f} s "
            f"({r['decode_tokens'] / r['decode_s']:.1f} tok/s), wall "
            f"{r['wall_s']:.2f} s; launches "
            f"{ {k: lc[k] for k in want} }")
        if r["done"] != 8 or any(len(q.out) != max_new
                                 for q in r["requests"]):
            raise AssertionError(f"use_kernel={mode!r}: not every request "
                                 f"completed {max_new} tokens")
        if mode is True:
            for k, n in want.items():
                if lc[k] != n:
                    raise AssertionError(f"the serve path launched {k} "
                                         f"{lc[k]} times, not {n}")
            add_launches(launches, lc)
        elif any(lc.values()):
            raise AssertionError(f"the plain serve run launched {lc}")
    same = sum(a == b for qa, qb in zip(runs[True]["requests"],
                                        runs["ref"]["requests"])
               for a, b in zip(qa.out, qb.out))
    log(f"phase {phase}: greedy tokens equal to the plain run's: {same} of "
        f"{8 * max_new} ({same / (8 * max_new):.4f})")
    check_f32(phase, cfg, params, prompts[:2])


# --- phase 6: the gla_chunk kernel ---------------------------------------------
def gla_inputs(g, b, s, h, dk, dv, dt, init: bool, strided: bool = False):
    """GLA inputs on the card: q, k, v in ``dt``, log-sigmoid gates in f32,
    and an initial (S0, n0) or None.  ``strided``: q and k are the two
    halves of one (B,S,H,2dk) tensor, as Mamba's C and B are."""
    import torch
    import torch.nn.functional as F
    rn = lambda *sh: torch.randn(sh, generator=g, device="cuda")
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


def gla_bound_ms(b, s, h, dk, dv, chunk, elt):
    """The least time for one gla_chunk call: the larger of its bytes (q,
    k, v in, y out in the model dtype; f32 gates in, f32 state and
    normaliser out) at 3.35 TB/s and its operations on and below each
    chunk's diagonal (scores, A.v, the decayed state read, the state carry
    and the normaliser's two dot products) at the bf16 tensor rate, as
    row 4 of the kernel table counts attention.  Beside it, the bf16
    route's own floors: its split work (q k^T once; A v, q S_in and
    (k w)^T v twice, as bf16 hi + lo terms) at the bf16 rate, and its
    bytes with the scratch round trips (the chunks' own f32 states, their
    bf16 hi + lo entering states from chunk 1 on, and the f32 scores of the
    64 x 64 tiles on and below the diagonal, each written once and read
    once) at 3.35 TB/s."""
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


def within(got, want, bf16: bool) -> float:
    """Largest ``|got - want| / (atol + rtol |want| [+ 1 bf16 ulp])`` with
    JAX's kernel-vs-chunkwise bound ``atol 1e-4, rtol 1e-3``
    (tests/test_kernels.py); <= 1 passes."""
    import torch
    g, w = got.float(), want.float()
    lim = 1e-4 + 1e-3 * w.abs()
    if bf16:
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        _, e = torch.frexp(mag)
        lim = lim + torch.ldexp(torch.ones_like(mag), e - 8)
    return float(((g - w).abs() / lim).max())


def phase_gla() -> dict:
    """gla_chunk against its plain version on the card over the sweep, and
    its bf16 route's distance to ``ref.gla_chunk_split`` (the emulation of
    its rounding); timings at xLSTM-350M's and Hymba-1.5B's prefill
    shapes."""
    import torch
    from repro_torch.kernels import gla_chunk as gla_mod
    from repro_torch.kernels import ref
    gla_chunk = gla_mod.gla_chunk
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(6)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = {"err": 0.0, "f32": 0.0, "bf16": 0.0, "split": 0.0}

    def check(args, st, chunk, normalize, dt, what):
        y, (S, n) = gla_chunk(*args, chunk=chunk, normalize=normalize,
                              init_state=st)
        ry, (rS, rn) = ref.gla_chunk_plain(*args, chunk=chunk,
                                           normalize=normalize,
                                           init_state=st)
        r = max(within(y, ry, dt == "bf16"), within(S, rS, False),
                within(n, rn, False))
        finite = all(bool(torch.isfinite(t).all()) for t in (y, S, n))
        if not (r <= 1.0 and finite):
            raise AssertionError(f"gla_chunk != plain ({what}): {r} of the "
                                 f"bound, finite {finite}")
        worst[dt] = max(worst[dt], r)
        worst["err"] = max(worst["err"], *(float((a.float() - b).abs().max())
                                          for a, b in ((y, ry.float()),
                                                       (S, rS), (n, rn))))
        if dt == "bf16":
            ey, (eS, en) = ref.gla_chunk_split(*args, chunk=chunk,
                                               normalize=normalize,
                                               init_state=st)
            worst["split"] = max(worst["split"], within(y, ey, True),
                                 within(S, eS, False), within(n, en, False))

    cases = 0
    for dt, tdt in dts.items():
        for dk, dv in ((16, 128), (512, 512), (64, 64), (16, 32)):
            b, h = (1, 2) if dk == 512 else (2, 3)
            for chunk in (16, 64, 256):
                for n_chunks in (1, 3):
                    for normalize in (True, False):
                        for init in (False, True):
                            s = chunk * n_chunks
                            args, st = gla_inputs(g, b, s, h, dk, dv, tdt,
                                                  init, strided=cases % 2)
                            check(args, st, chunk, normalize, dt,
                                  f"{dt} dk={dk} dv={dv} B={b} H={h} S={s} "
                                  f"chunk={chunk} normalize={normalize} "
                                  f"init={init}")
                            cases += 1
    # the main path's shapes: an xLSTM layer's 2048-token prompt (4 heads,
    # dk = dv = 512, normalised) and a Hymba layer's 128 + 2048 tokens
    # padded to 2304 (25 heads, dk 16, dv 128, not normalised), bf16
    shapes = {"xlstm-350m": (1, 2048, 4, 512, 512, True),
              "hymba-1.5b": (1, 2304, 25, 16, 128, False)}
    main_args = {}
    for name, (b, s, h, dk, dv, normalize) in shapes.items():
        args, _ = gla_inputs(g, b, s, h, dk, dv, torch.bfloat16, False)
        check(args, None, 256, normalize, "bf16", f"{name} prefill shape")
        main_args[name] = (args, normalize)
        cases += 1
    torch.cuda.synchronize()
    log(f"phase 6: gla_chunk == plain within tolerance over {cases} cases "
        f"(f32: atol 1e-4 + rtol 1e-3, worst {worst['f32']:.3f} of it; "
        f"bf16 y: + 1 ulp, worst {worst['bf16']:.3f}); max |diff| "
        f"{worst['err']:.3e}; the bf16 route against ref.gla_chunk_split "
        f"(its rounding), worst {worst['split']:.3f} of the same bound")

    out = {}
    for name, (b, s, h, dk, dv, _) in shapes.items():
        args, normalize = main_args[name]
        bd = gla_bound_ms(b, s, h, dk, dv, 256, 2)
        ms = time_ms(lambda: gla_chunk(*args, normalize=normalize), 20)
        plain = time_ms(lambda: ref.gla_chunk_plain(*args,
                                                    normalize=normalize), 10)
        log(f"phase 6: gla_chunk at {name}'s prefill shape (B={b}, S={s}, "
            f"H={h}, dk={dk}, dv={dv}, chunk 256, bf16): {ms * 1e3:.2f} us, "
            f"plain {plain * 1e3:.2f} us, bound {bd['bound_ms'] * 1e3:.2f} "
            f"us ({bd['bound_by']}: {bd['flops'] / 1e9:.3f} GFLOP, "
            f"{bd['bytes'] / 1e6:.2f} MB); split work "
            f"{bd['split_flops'] / 1e9:.3f} GFLOP, {bd['split_ms'] * 1e3:.2f}"
            f" us; with the scratch {bd['design_bytes'] / 1e6:.2f} MB, "
            f"{bd['design_ms'] * 1e3:.2f} us; blocks "
            f"{gla_mod.tc_blocks(b, s, h, dk, dv, 256)} on "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} "
            f"SMs")
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bd["bound_ms"],
                         bound_by=bd["bound_by"], library_ms=None,
                         max_abs_err=worst["err"])
    return out


# --- phase 8: Hymba-1.5B by direct prefill and decode calls ------------------
def phase_hymba(launches: dict) -> None:
    """Hymba-1.5B at full width: two prompts (~1,000 and 2,048 tokens),
    prefill then 16 greedy decode steps each at pos0 = meta + S + j,
    through the kernels and their plain versions; then the f32 check."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = build_model(8, "hymba-1.5b")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (1000, 2048)]
    steps = 16
    ring = cfg.meta_tokens + cfg.sliding_window
    log(f"phase 8: prompts of {[len(p) for p in prompts]} tokens + "
        f"{cfg.meta_tokens} meta tokens, {steps} decode steps each, a "
        f"{ring}-slot ring (the second prompt packs it, its decode wraps)")
    n_l = cfg.n_layers
    want = {"gla_chunk": n_l * len(prompts),
            "flash_attention": n_l * len(prompts),
            "decode_attention": n_l * len(prompts) * steps}
    # untimed warm-up of both paths on the same prompts (as in phase 5)
    for mode in (True, "ref"):
        for p in prompts:
            run_request(dataclasses.replace(cfg, use_kernel=mode), params, p,
                        2)
    outs = {}
    for mode in (True, "ref"):
        c = dataclasses.replace(cfg, use_kernel=mode)
        reset_launch_counts()
        torch.cuda.synchronize()
        res = [run_request(c, params, p, steps) for p in prompts]
        lc = launch_counts()
        outs[mode] = res
        pre_s, dec_s = sum(r[2] for r in res), sum(r[3] for r in res)
        n_pre = sum(cfg.meta_tokens + len(p) for p in prompts)
        log(f"phase 8: use_kernel={mode!r}: prefill {n_pre} tokens (meta "
            f"included) in {pre_s:.3f} s ({n_pre / pre_s:.1f} tok/s), decode "
            f"{steps * len(prompts)} tokens in {dec_s:.3f} s "
            f"({steps * len(prompts) / dec_s:.1f} tok/s); launches "
            f"{ {k: lc[k] for k in want} }")
        for logits, *_ in res:
            if not bool(torch.isfinite(logits).all()) or \
                    logits.shape != (steps + 1, cfg.vocab):
                raise AssertionError(f"use_kernel={mode!r}: logits "
                                     f"{tuple(logits.shape)} not finite")
        if mode is True:
            for k, n in want.items():
                if lc[k] != n:
                    raise AssertionError(f"the Hymba path launched {k} "
                                         f"{lc[k]} times, not {n}")
            add_launches(launches, lc)
        elif any(lc.values()):
            raise AssertionError(f"the plain Hymba run launched {lc}")
    same = sum(a == b for rk, rr in zip(outs[True], outs["ref"])
               for a, b in zip(rk[1], rr[1]))
    log(f"phase 8: greedy tokens equal to the plain run's: {same} of "
        f"{len(prompts) * (steps + 1)}")
    check_f32(8, cfg, params, prompts)


# --- phases 9-10: the sweep grid and the streaming replay --------------------
def grid_arrays(g) -> dict:
    """A SweepGrid's result fields as host numpy arrays."""
    import dataclasses
    return {f.name: getattr(g.result, f.name).cpu().numpy()
            for f in dataclasses.fields(g.result)}


def same_grid(a, b) -> bool:
    """Every field of two SweepGrids' results (or their ``grid_arrays``),
    bit for bit."""
    import torch
    fa, fb = (x if isinstance(x, dict) else grid_arrays(x) for x in (a, b))
    return fa.keys() == fb.keys() and all(
        bitwise_equal(torch.from_numpy(fa[k]), torch.from_numpy(fb[k]))
        for k in fa)


def fig2_plain(conn) -> None:
    """9(a)'s run through the plain versions, in a process of its own:
    sends back ("ok", its grids' ``grid_arrays``) or ("error", the
    traceback that stopped it)."""
    try:
        from repro_torch.figures import fig2_synthetic
        grids = []
        drive("phase 9a: fig2_synthetic.run(use_kernel='ref')",
              lambda c: fig2_synthetic.run(use_kernel="ref", counters=c,
                                           n_requests=FIG2_GRID_REQUESTS,
                                           grids=grids))
        conn.send(("ok", [grid_arrays(g) for g in grids]))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def phase_grid_fig2(launches: dict, grids_out: dict) -> None:
    """9(a): fig2 at the driver's default size through the figure driver,
    the kernels' grids against the plain versions' bit for bit.  The two
    runs go side by side, the plain one in a second process (both are
    host-bound), so 9(a)'s rates are read with the host shared."""
    import multiprocessing
    from repro_torch.figures import fig2_synthetic
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=fig2_plain, args=(send,))
    child.start()
    send.close()
    try:
        kern = []
        rows, _, lc = drive(
            "phase 9a: fig2_synthetic.run(use_kernel=True)",
            lambda c: fig2_synthetic.run(use_kernel=True, counters=c,
                                         n_requests=FIG2_GRID_REQUESTS,
                                         grids=kern),
            ("ranking_victim_order", "lane_scatter"))
        add_launches(launches, lc)
        status, plain = recv.recv()
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.terminate()
            child.join()
    if status != "ok":
        raise AssertionError(f"phase 9a's plain run failed:\n{plain}")
    if len(kern) != 4 or len(plain) != 4:
        raise AssertionError(f"fig2 ran {len(kern)} / {len(plain)} grids, "
                             f"not 4")
    for a, b in zip(kern, plain):
        if not same_grid(a, b):
            raise AssertionError(f"fig2 grid {a.policies}: kernels "
                                 f"{grid_arrays(a)} != plain {b}")
    log(f"phase 9a: {len(plain)} grids (2 arrivals x recency roster / "
        f"rate trio), kernels == plain bitwise in every lane")
    for r in rows:
        log(f"phase 9a: {r['arrival']:7s} resid={r['resid']:7s} "
            f"{r['policy']:12s} improvement over LRU "
            f"{r['improvement_vs_lru'] * 100:8.3f}%  hit ratio "
            f"{r['hit_ratio']}")
    ours = [r for r in rows if r["policy"] == "stoch_vacdh"
            and r["arrival"] == "poisson" and r["resid"] == "recency"]
    impr = ours[0]["improvement_vs_lru"]
    if not 0.03 <= impr <= 0.30:
        raise AssertionError(f"fig2 grid improvement {impr} outside 3-30%")
    grids_out["fig2_rate_poisson"] = kern[1]


def phase_grid_deploy(n_requests: int, launches: dict) -> None:
    """9(b): lru / vacdh / stoch_vacdh x omega {0.5, 1, 2} x capacity
    {5%, 10%} over the dense 2^20-object universe: 18 lanes."""
    import torch
    from repro_torch.core import PolicyParams, simulate, sweep_grid
    from repro_torch.core.state import F32_FIELDS
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace

    spec = SyntheticSpec(n_objects=N_DEPLOY, n_requests=n_requests,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(7), spec)
    touched = torch.unique(tr.objs.long())
    foot = float(tr.sizes[touched].sum())
    caps = [0.05 * foot, 0.10 * foot]
    omegas = (0.5, 1.0, 2.0)
    params = [PolicyParams(omega=o, resid="recency") for o in omegas]
    policies = ["lru", "vacdh", "stoch_vacdh"]
    n_lanes = len(policies) * len(params) * len(caps)
    state_mb = (len(F32_FIELDS) * 4 + 2) * N_DEPLOY * n_lanes / 1e6
    log(f"phase 9b: {n_lanes} lanes ({policies} x omega {omegas} x "
        f"capacity 5%/10% of {foot:.1f} MB) over {N_DEPLOY} objects, "
        f"{state_mb:.1f} MB of state; {n_requests} requests (cut for the "
        f"host-bound replay rate)")

    def grid(mode):
        return lambda c: sweep_grid(tr, caps, policies, params,
                                    estimate_z=True, use_kernel=mode,
                                    counters=c)

    t0 = time.perf_counter()
    kern, kc, lc = drive("phase 9b: sweep_grid(kernels)", grid(True),
                         ("ranking_victim_order", "lane_scatter"))
    grid_s = time.perf_counter() - t0
    add_launches(launches, lc)
    plain, pc, _ = drive("phase 9b: sweep_grid(plain versions)", grid("ref"))
    if not same_grid(kern, plain):
        raise AssertionError("18-lane grid: kernels != plain versions")
    log("phase 9b: kernel grid == plain grid bitwise in all 18 lanes")
    walls = []
    for pol, pi, ci in (("stoch_vacdh", 1, 1), ("vacdh", 0, 0),
                        ("lru", 2, 1)):
        t0 = time.perf_counter()
        one, _, lc = drive(
            f"phase 9b: simulate({pol}, omega {omegas[pi]}, capacity "
            f"{caps[ci]:.1f})",
            lambda c, pol=pol, pi=pi, ci=ci: simulate(
                tr, caps[ci], pol, params[pi], estimate_z=True,
                use_kernel=True, counters=c),
            ("lane_scatter",))
        add_launches(launches, lc)
        walls.append(time.perf_counter() - t0)
        if not same_result(one, kern.point(0, policies.index(pol), pi, ci,
                                           0)):
            raise AssertionError(f"grid lane {pol} != single-lane simulate")
    one_lane = statistics.mean(walls) * n_lanes
    log(f"phase 9b: grid lanes == single-lane simulate bitwise (stoch_vacdh, "
        f"vacdh, lru); grid {grid_s:.2f} s for {n_lanes} lanes "
        f"({kc['lane_requests'] / grid_s:.1f} lane-requests/s, "
        f"{kc['syncs'] / kc['lane_requests']:.4f} syncs/lane-request, "
        f"{kc['scoring_commits']} scoring commits) against "
        f"{one_lane:.2f} s as {n_lanes} one-lane runs (extrapolated from "
        f"the three single-lane runs' mean, {statistics.mean(walls):.2f} s: "
        f"{n_requests / statistics.mean(walls):.1f} lane-requests/s)")


def phase_stream(launches: dict, grids: dict) -> None:
    """10: the epoch-time stream, rebased, kernels against plain; chunked
    replays against whole ones."""
    import numpy as np
    import torch
    from repro_torch.core import (PolicyParams, simulate, simulate_chunked,
                                  simulate_stream, sweep_grid)
    from repro_torch.data.traces import (RealWorldSpec, SyntheticSpec,
                                         compact_requests, realworld_raw,
                                         synthetic_trace)

    n_req = 20_000
    raw = realworld_raw(RealWorldSpec(n_requests=n_req, n_keys=200_000,
                                      seed=0))
    stream, stats = compact_requests(raw, top_k=4096, n_recycle=512)
    cap = 0.1 * float(stream.sizes.sum())
    log(f"phase 10: stream of {stream.n_requests} requests (cut from "
        f"fig_realworld's 1,000,000 for time) from t = "
        f"{stream.times[0]:.1f} s, "
        f"{stats.n_unique} keys -> {stats.n_objects} objects (tail mass "
        f"{stats.tail_mass:.3f}), capacity {cap:.1f} MB, chunks of 4096")
    params = PolicyParams(omega=1.0)
    runs = {}
    for mode, needs in ((True, ("ranking_victim_order", "lane_scatter")),
                        ("ref", ())):
        runs[mode] = drive(
            f"phase 10: simulate_stream(use_kernel={mode!r}, rebase=True)",
            lambda c, mode=mode: simulate_stream(
                stream, cap, "stoch_vacdh", params, estimate_z=True,
                use_kernel=mode, chunk_size=4096, rebase=True, counters=c),
            needs)
        if mode is True:
            add_launches(launches, runs[mode][2])
    if not same_result(runs[True][0], runs["ref"][0]):
        raise AssertionError(f"stream: kernels {runs[True][0]} != plain "
                             f"{runs['ref'][0]}")
    r = runs[True][0]
    if int(r.n_hits + r.n_delayed + r.n_misses) != stream.n_requests or \
            not bool(
            torch.isfinite(r.total_latency)):
        raise AssertionError(f"stream result {r}")
    log(f"phase 10: stream kernels == plain bitwise: latency "
        f"{float(r.total_latency)}, hit ratio {float(r.hit_ratio):.4f}")

    spec = SyntheticSpec(n_objects=100, n_requests=FIG2_GRID_REQUESTS,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(0), spec)
    p2 = PolicyParams(omega=1.0, resid="recency")
    whole, _, lc = drive("phase 10: fig2 simulate(kernels)", lambda c:
                         simulate(tr, 500.0, "stoch_vacdh", p2,
                                  estimate_z=True, counters=c),
                         ("ranking_victim_order", "lane_scatter"))
    add_launches(launches, lc)
    chunked, _, lc = drive("phase 10: fig2 simulate_chunked(4096)", lambda c:
                           simulate_chunked(tr, 500.0, "stoch_vacdh", p2,
                                            estimate_z=True, chunk_size=4096,
                                            counters=c),
                           ("ranking_victim_order", "lane_scatter"))
    add_launches(launches, lc)
    if not same_result(whole, chunked):
        raise AssertionError(f"simulate_chunked {chunked} != {whole}")
    g0 = grids["fig2_rate_poisson"]
    g1, _, lc = drive(
        "phase 10: fig2 rate grid, sweep_grid(chunk_size=4096)",
        lambda c: sweep_grid(tr, 500.0, list(g0.policies), list(g0.params),
                             estimate_z=True, chunk_size=4096, counters=c),
        ("ranking_victim_order", "lane_scatter"))
    add_launches(launches, lc)
    if not same_grid(g0, g1):
        raise AssertionError("chunked grid != unchunked grid")
    log(f"phase 10: simulate_chunked == simulate and the chunked "
        f"{np.prod(g0.result.total_latency.shape)}-lane grid == the "
        f"unchunked grid, bit for bit")



# --- phases 11-12: the slot table and the hierarchy --------------------------
def eviction_pick_launches(n: int) -> tuple[int, int, float, float]:
    """Device kernels of one eviction of the per-eviction loop at ``n``
    entries, with the slot table's id tie-break and with the dense
    position tie-break (``torch.profiler``), and their CUDA-event times
    in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.simulator import eviction_pick
    g = torch.Generator(device="cuda").manual_seed(11)
    ranks = torch.rand(n, generator=g, device="cuda")
    cached = torch.rand(n, generator=g, device="cuda") < 0.5
    ids = torch.randperm(n, generator=g, device="cuda").to(torch.int32)
    out = []
    for i in (ids, None):
        eviction_pick(cached, ranks, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eviction_pick(cached, ranks, i)
            torch.cuda.synchronize()
        out.append(sum(1 for e in prof.events()
                       if e.device_type == DeviceType.CUDA))
    return (*out, time_ms(lambda: eviction_pick(cached, ranks, ids)),
            time_ms(lambda: eviction_pick(cached, ranks, None)))


def phase_slots(launches: dict) -> None:
    """11: phase 10's raw stream, every key its own id, replayed through a
    2^19-slot table (kernels against plain versions, slots against dense),
    then a prefix under two hash seeds and through a table of half its
    keys (reclaim)."""
    import numpy as np
    from repro_torch.core import PolicyParams, RequestStream, simulate_stream
    from repro_torch.core.state import slot_table_size
    from repro_torch.data.traces import (RealWorldSpec, exact_requests,
                                         realworld_raw)

    raw = realworld_raw(RealWorldSpec(n_requests=STREAM_REQUESTS,
                                      n_keys=N_KEYS, seed=0))
    stream, stats = exact_requests(raw)
    n_slots = slot_table_size(N_KEYS, load=0.75)
    cap = 0.1 * float(stream.sizes.sum())
    log(f"phase 11: {stream.n_requests} requests, {stats.n_unique} of "
        f"{N_KEYS} keys touched, each its own id; {n_slots} slots "
        f"(slot_table_size({N_KEYS}, load=0.75)), capacity {cap:.1f} MB, "
        f"chunks of 4096, rebased")
    params = PolicyParams(omega=1.0)

    def replay(st, mode, label, needs, **kw):
        out, counts, lc = drive(
            f"phase 11: {label}",
            lambda c: simulate_stream(st, cap, "stoch_vacdh", params,
                                      estimate_z=True, use_kernel=mode,
                                      chunk_size=4096, rebase=True,
                                      counters=c, **kw), needs)
        if mode is True:
            add_launches(launches, lc)
            per_req = lc["ranking_scores"] / counts["requests"]
            log(f"phase 11: {label}: {per_req:.4f} ranking_scores "
                f"launches/request, {counts.get('reclaims', 0)} reclaims")
        return out, counts

    kern, kc = replay(stream, True, "slots, kernels",
                      ("ranking_scores", "lane_scatter"),
                      state_mode="slots", n_slots=n_slots)
    plain, _ = replay(stream, "ref", "slots, plain versions", (),
                      state_mode="slots", n_slots=n_slots)
    if not same_result(kern, plain):
        raise AssertionError(f"slots: kernels {kern} != plain {plain}")
    dense, _ = replay(stream, True, "dense, evict_top=0, kernels",
                      ("ranking_scores", "lane_scatter"), evict_top=0)
    if not same_result(kern, dense):
        raise AssertionError(f"slots {kern} != dense {dense}")
    n = int(kern.n_hits + kern.n_delayed + kern.n_misses)
    if n != stream.n_requests or kc["reclaims"]:
        raise AssertionError(f"slots: {n} requests, {kc['reclaims']} "
                             f"reclaims")
    log(f"phase 11: slots == plain == dense bitwise: latency "
        f"{float(kern.total_latency)}, hit ratio {float(kern.hit_ratio):.4f}"
        f", evictions {int(kern.n_evictions)}")

    k = SLOT_PREFIX
    pre = RequestStream(stream.times[:k], stream.objs[:k], stream.sizes,
                        stream.z_mean, stream.z_draw[:k])
    n_pre = int(np.unique(pre.objs).size)
    seeds = [replay(pre, True, f"prefix, slot_seed {sd}",
                    ("ranking_scores", "lane_scatter"), state_mode="slots",
                    slot_seed=sd)[0] for sd in (0, 1)]
    if not same_result(*seeds):
        raise AssertionError(f"slot seeds differ: {seeds}")
    small = dict(state_mode="slots", n_slots=n_pre // 2)
    rk, rc = replay(pre, True, f"prefix, {n_pre // 2} slots, kernels",
                    ("ranking_scores", "lane_scatter"), **small)
    rp, _ = replay(pre, "ref", f"prefix, {n_pre // 2} slots, plain "
                   f"versions", (), **small)
    if not same_result(rk, rp):
        raise AssertionError(f"reclaim: kernels {rk} != plain {rp}")
    if rc["reclaims"] <= 0 or int(rk.n_hits + rk.n_delayed
                                  + rk.n_misses) != k:
        raise AssertionError(f"reclaim run: {rk}, {rc}")
    log(f"phase 11: {k}-request prefix ({n_pre} keys): slot seeds 0 and 1 "
        f"bitwise equal; {n_pre // 2} slots: {rc['reclaims']} reclaims, "
        f"kernels == plain bitwise, every request counted")
    tb, dn, tb_ms, dn_ms = eviction_pick_launches(n_slots)
    log(f"phase 11: one eviction's pick at {n_slots} slots: {tb} device "
        f"kernels with the id tie-break ({tb_ms * 1e3:.2f} us), {dn} with "
        f"the position tie-break ({dn_ms * 1e3:.2f} us)")


def hier_grid_arrays(g) -> dict:
    """A HierSweepGrid's result fields as host numpy arrays."""
    import dataclasses
    return {f"{tier}.{f.name}": getattr(getattr(g.result, tier),
                                        f.name).cpu().numpy()
            for tier in ("per_shard", "l2")
            for f in dataclasses.fields(g.result.l2)}


def fig6_plain(conn) -> None:
    """12(a)'s run through the plain versions, in a process of its own:
    sends back ("ok", its grids' ``hier_grid_arrays``) or ("error", the
    traceback)."""
    try:
        from repro_torch.figures import fig6_hierarchy
        grids = []
        drive("phase 12a: fig6_hierarchy.run(use_kernel='ref')",
              lambda c: fig6_hierarchy.run(use_kernel="ref", counters=c,
                                           n_requests=HIER_REQUESTS,
                                           grids=grids))
        conn.send(("ok", [hier_grid_arrays(g) for g in grids]))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def phase_hier(launches: dict) -> None:
    """12: (a) fig6 over its default grid at ``HIER_REQUESTS``, kernel
    writes against plain writes (a second process, side by side) bit for
    bit; (b) a deployment-size hierarchy over the 2^20-object universe."""
    import multiprocessing
    import torch
    from repro_torch.core import (Exponential, PolicyParams,
                                  make_hier_trace, simulate_hier)
    from repro_torch.core.state import F32_FIELDS
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace
    from repro_torch.figures import fig6_hierarchy

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=fig6_plain, args=(send,))
    child.start()
    send.close()
    try:
        kern = []
        rows, _, lc = drive(
            "phase 12a: fig6_hierarchy.run(use_kernel=True)",
            lambda c: fig6_hierarchy.run(use_kernel=True, counters=c,
                                         n_requests=HIER_REQUESTS,
                                         grids=kern), ("lane_scatter",))
        add_launches(launches, lc)
        status, plain = recv.recv()
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.terminate()
            child.join()
    if status != "ok":
        raise AssertionError(f"phase 12a's plain run failed:\n{plain}")
    if len(kern) != 4 or len(plain) != 4:
        raise AssertionError(f"fig6 ran {len(kern)} / {len(plain)} grids")
    for a, b in zip(kern, plain):
        fa = hier_grid_arrays(a)
        if fa.keys() != b.keys() or not all(
                bitwise_equal(torch.from_numpy(fa[k]),
                              torch.from_numpy(b[k])) for k in fa):
            raise AssertionError(f"fig6 grid (S={a.n_shards}): kernel "
                                 f"writes != plain writes")
    log(f"phase 12a: 4 grids (routes hash/random x S 1/4; 4 hop laws x 3 "
        f"policies x L2 0/2000 each), {HIER_REQUESTS} requests: kernel "
        f"writes == plain writes bitwise in every point")
    for r in rows:
        if r["policy"] == "stoch_vacdh":
            log(f"phase 12a: route={r['route']:6s} S={r['n_shards']} "
                f"hop={r['hop_dist']:8s} (CV {r['hop_cv']}) L2="
                f"{r['l2_capacity']:6.0f}: eq.-16 improvement over LRU "
                f"{r['improvement_vs_lru'] * 100:8.3f}%, L1 hit ratio "
                f"{r['l1_hit_ratio']}, L2 hit ratio {r['l2_hit_ratio']}")
        if not torch.isfinite(torch.tensor(r["total_latency"])):
            raise AssertionError(f"fig6 row {r}")

    spec = SyntheticSpec(n_objects=N_DEPLOY, n_requests=HIER_REQUESTS,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(7), spec)
    foot = float(tr.sizes[torch.unique(tr.objs.long())].sum())
    ht = make_hier_trace(tr, 4, generator=torch.Generator().manual_seed(7),
                         hop_mean=0.01, hop_dist=Exponential(), route="hash")
    c1, c2 = 0.05 * foot, 0.20 * foot
    state_mb = (len(F32_FIELDS) * 4 + 2) * N_DEPLOY * 5 / 1e6
    log(f"phase 12b: 4 hash-routed L1 shards (stoch_vacdh, {c1:.1f} MB "
        f"each = 5% of the touched {foot:.1f} MB) over an LRU L2 "
        f"({c2:.1f} MB), exponential hops of mean 0.01 s, {N_DEPLOY} "
        f"objects ({state_mb:.1f} MB of state), {HIER_REQUESTS} requests")
    params = PolicyParams(omega=1.0, resid="recency")
    runs = {}
    for mode, needs in ((True, ("lane_scatter",)), ("ref", ())):
        runs[mode] = drive(
            f"phase 12b: simulate_hier(use_kernel={mode!r})",
            lambda c, mode=mode: simulate_hier(
                ht, 4, c1, c2, "stoch_vacdh", "lru", params=params,
                use_kernel=mode, counters=c), needs)
    add_launches(launches, runs[True][2])
    a, b = runs[True][0], runs["ref"][0]
    if not (same_result(a.l2, b.l2) and all(
            bitwise_equal(getattr(a.per_shard, f), getattr(b.per_shard, f))
            for f in ("total_latency", "n_hits", "n_delayed", "n_misses",
                      "n_evictions"))):
        raise AssertionError(f"12b: kernel writes {a} != plain {b}")
    l2_arr = int(a.l2.n_hits + a.l2.n_delayed + a.l2.n_misses)
    if int(a.n_requests) != HIER_REQUESTS or l2_arr != int(a.n_misses):
        raise AssertionError(f"12b counts: {a}")
    log(f"phase 12b: kernel writes == plain writes bitwise: latency "
        f"{float(a.total_latency)}, L1 hit ratio {float(a.hit_ratio):.4f}, "
        f"L2 arrivals {l2_arr} = L1 misses, L2 hits {int(a.l2.n_hits)}")


# --- phase 13: the serving engine --------------------------------------------
SERVE_REQUESTS = 20_000       # phase 13(b)'s flash crowd
SERVE_OBJECTS = 1 << 18       # phase 13(b)'s prefix table


def serve_cost_check(label: str, admits: int, ranks: int, rank_launches: int,
                     scatter_launches: int, eq16: bool) -> None:
    """The launch rules of a kernel run of the serving engine: at least one
    lane-scatter launch a rank (each rank flushes the mirror first), a
    rank an admission, and for eq.-16 caches at least one
    ``ranking_victim_order`` launch an admission."""
    if scatter_launches < ranks or ranks < admits:
        raise AssertionError(f"{label}: {scatter_launches} lane-scatter "
                             f"launches for {ranks} ranks, {admits} "
                             f"admissions")
    if eq16 and rank_launches < admits:
        raise AssertionError(f"{label}: {rank_launches} ranking launches "
                             f"for {admits} admissions")


def phase_serving(launches: dict) -> None:
    """13: (a) ``bench_serving.run(smoke=True)`` through the kernels and
    through the plain versions, rows equal; (b) a flash crowd over
    ``N_KEYS`` keys through a 2^18-object prefix table, eq. 16 and LRU,
    kernels against plain versions request by request."""
    import torch
    from repro_torch.data.scenarios import make_scenario
    from repro_torch.figures import bench_serving as bs
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def run(fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    # the card against the CPU on a small workload
    w = make_scenario("flash_crowd", seed=3, n_requests=600, n_keys=80)
    small = []
    for dev in ("cuda", "cpu"):
        eng = bs._make_engine(w, hedging=True, hier=False, device=dev)
        sq, depth, _, n, shed, failed = bs._drive(w, eng)
        small.append((eng.stats.as_dict(), sq.counts.tolist(), sq.sum,
                      depth.tolist(), n, shed, failed))
    if small[0] != small[1]:
        raise AssertionError(f"13: card {small[0]} != cpu {small[1]}")
    log("phase 13: flash crowd, 600 requests: card == CPU (every counter, "
        "the latency sum and the sketch)")

    res = {}
    for mode in (None, "ref"):
        cost = {}
        rows, dt, lc = run(lambda mode=mode: bs.run(
            smoke=True, use_kernel=mode, counters=cost,
            out=os.path.join(ROOT, "src", "repro_torch", "figures",
                             "results", f"bench_serving_{mode or 'kernel'}"
                                        ".json")))
        res[mode] = rows
        if mode is None:
            serve_cost_check("13a kernels", cost["admits"], cost["ranks"],
                             cost["rank_launches"], cost["scatter_launches"],
                             True)
            add_launches(launches, lc)
        elif any(lc.values()):
            raise AssertionError(f"13a plain run launched kernels: {lc}")
        a = cost["admits"]
        log(f"phase 13a: bench_serving.run(smoke=True, use_kernel="
            f"{mode!r}): {dt:.2f} s; measured segments "
            f"{cost['requests']} requests in {cost['seconds']:.2f} s = "
            f"{cost['requests'] / cost['seconds']:.1f} req/s, "
            f"{cost['syncs'] / cost['requests']:.4f} syncs/request, "
            f"{a} admissions, {cost['ranks'] / a:.4f} ranks, "
            f"{cost['rank_launches'] / a:.4f} ranking and "
            f"{cost['scatter_launches'] / a:.4f} lane-scatter launches an "
            f"admission; launches over the run {lc}")
    strip = lambda r: {k: v for k, v in r.items() if k not in bs.MEASURED}
    if [strip(r) for r in res[None]] != [strip(r) for r in res["ref"]]:
        bad = [(strip(a), strip(b)) for a, b in zip(res[None], res["ref"])
               if strip(a) != strip(b)]
        raise AssertionError(f"13a: kernel rows != plain rows: {bad[:2]}")
    for r in res[None]:
        if r["mode"] == "slo_search":
            log(f"phase 13a: {r['scenario']:16s} slo_search hedged="
                f"{r['hedging']!s:5s} {r['req_s_at_slo']} req/s at the "
                f"{r['slo_ms']} ms p99 (x{r['rate_mult_at_slo']})")
            continue
        log(f"phase 13a: {r['scenario']:16s} {r['mode']:6s} hedged="
            f"{r['hedging']!s:5s} p50/p99/p99.9 {r['p50_ms']}/"
            f"{r['p99_ms']}/{r['p999_ms']} ms, {r['drive_req_per_s']} "
            f"req/s, {r['syncs_per_req']} syncs, "
            f"{r['rank_launches_per_req']} ranking and "
            f"{r['scatter_launches_per_req']} lane-scatter launches a "
            f"request, shed {r['shed']}, failed {r['failed']}, retries "
            f"{r['retries']}")
    log(f"phase 13a: {len(res[None])} rows, kernels == plain in every "
        f"field but {bs.MEASURED}")

    w = make_scenario("flash_crowd", seed=0, n_requests=SERVE_REQUESTS,
                      n_keys=N_KEYS)
    foot = bs._footprint(w)
    reqs = [(float(t), f"p{k}", int(n))
            for t, k, n in zip(w.times, w.keys, w.n_tokens)]
    log(f"phase 13b: flash crowd, {SERVE_REQUESTS} requests over {N_KEYS} "
        f"keys ({len(set(w.keys.tolist()))} touched), capacity 25% of the "
        f"{foot:.0f}-token footprint, {SERVE_OBJECTS}-object table, hedged")
    for policy in ("stoch_vacdh", "lru"):
        out = {}
        for mode in (None, "ref"):
            eng = bs._make_engine(w, hedging=True, hier=False,
                                  policy=policy, use_kernel=mode,
                                  max_objects=SERVE_OBJECTS)
            got, dt, lc = run(lambda eng=eng: [eng.serve(*q) for q in reqs])
            c = eng.cache.counters
            out[mode] = (got, eng.stats.as_dict())
            if mode is None:
                serve_cost_check(f"13b {policy}", c["admits"], c["ranks"],
                                 lc["ranking_victim_order"],
                                 lc["lane_scatter"], policy == "stoch_vacdh")
                add_launches(launches, lc)
            elif any(lc.values()):
                raise AssertionError(f"13b plain run launched: {lc}")
            log(f"phase 13b: {policy} use_kernel={mode!r}: {dt:.2f} s, "
                f"{SERVE_REQUESTS / dt:.1f} req/s, "
                f"{c['syncs'] / SERVE_REQUESTS:.4f} syncs/request, "
                f"{c['admits']} admissions, {c['ranks']} ranks, "
                f"{c['flushed'] / max(c['flushes'], 1):.2f} objects a "
                f"flush, mirror {eng.cache.mirror_bytes} bytes, launches "
                f"{lc}")
        if out[None] != out["ref"]:
            k = next((i for i, (a, b) in enumerate(zip(out[None][0],
                                                       out["ref"][0]))
                      if a != b), None)
            raise AssertionError(f"13b {policy}: kernels != plain (first "
                                 f"request {k}): {out[None][1]} vs "
                                 f"{out['ref'][1]}")
        st = out[None][1]
        log(f"phase 13b: {policy}: kernels == plain in every (outcome, "
            f"latency) and counter: hits {st['hits']}, delayed "
            f"{st['delayed_hits']}, misses {st['misses']}, evictions "
            f"{st['evictions']}, hedges {st['hedges']}, mean latency "
            f"{st['mean_latency']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=20_000,
                    help="requests of the deployment-size replay (phase 3)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"phase 0: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = round(time.perf_counter() - t, 1)
        log(f"phase {name}: {phase_s[name]} s")
        return out

    timings = timed("1", phase_kernels)
    timings.update(timed("4", phase_attention))
    launches, grids = {}, {}
    timed("2", phase_paper, launches)
    timed("3", phase_deploy, args.requests, launches)
    timed("5", phase_serve, 5, SERVE_ARCH, launches, ("flash_attention",),
          ("decode_attention",))
    gla = timed("6", phase_gla)
    timings["gla_chunk"] = gla["xlstm-350m"]
    timed("7", phase_serve, 7, "xlstm-350m", launches, ("gla_chunk",), ())
    timed("8", phase_hymba, launches)
    timed("9a", phase_grid_fig2, launches, grids)
    timed("9b", phase_grid_deploy, GRID_REQUESTS, launches)
    timed("10", phase_stream, launches, grids)
    timed("11", phase_slots, launches)
    timed("12", phase_hier, launches)
    timed("13", phase_serving, launches)
    log(f"seconds by phase: {phase_s}")
    log(f"launches over the main-path runs of phases 2-3 and 5-13: "
        f"{launches}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")

    meta = {
        "ranking_victim_order": ("kernels/csrc/ranking_score.cu",
                                 "src/repro/kernels/ranking_score.py:115"),
        "ranking_scores": ("kernels/csrc/ranking_score.cu",
                           "src/repro/kernels/ranking_score.py:44"),
        "lane_scatter": ("kernels/csrc/lane_scatter.cu",
                         "src/repro/kernels/lane_scatter.py:81"),
        "flash_attention": ("kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:79"),
        "decode_attention": ("kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:72"),
        "gla_chunk": ("kernels/csrc/gla_chunk.cu",
                      "src/repro/kernels/gla_chunk.py:81"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        tm = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/" + src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm.get("bound_by", "bytes"),
            "library_ms": tm["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
