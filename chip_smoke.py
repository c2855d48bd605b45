#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (any mismatch or fault raises and the script exits non-zero):

0. build every CUDA kernel from src/repro_torch/kernels/csrc (one nvcc per
   source, started together);
1. each kernel's wrapper against its plain PyTorch version on the card,
   bitwise, at the main path's shapes, with CUDA-event timings;
2. the paper's result: eq. 17 improvement of the eq.-16 policy over LRU on
   the fig2 synthetic workload through the kernels, held bitwise against
   the same run through the plain versions on the card, plus the card's
   run against the CPU run of a small trace;
3. the state at deployment size: a dense table over 2^20 objects, with the
   kernel path held against the plain path and the ``evict_top=0`` path;
4. the two attention kernels against their plain versions on the card over
   head widths 16/32/64/128, GQA groups 1/4/12/24, ragged Sq and Sk,
   windows of 4096 (with and without a sink) and 32, softcap 0 and 30, a
   wrapped ring-buffer cache with empty slots, in f32 (max |diff| <= 1e-5)
   and bf16 (at most one bf16 ulp of each output element, plus 1e-5); then
   their times at StableLM-2-1.6B's shapes beside the plain versions and
   PyTorch's ``scaled_dot_product_attention``;
5. the LM serve path at full width: ``stablelm-1.6b`` (24 layers, d 2048,
   bf16, random weights from a seed) behind a ``ContinuousBatcher``
   (max_batch 4, 8 requests of 512-2048 prompt tokens, 32 new tokens
   each) through the kernels, the same requests through the plain
   versions, and an f32 check of prefill and teacher-forced decode logits
   of the kernel path against the plain path.

Each main-path run starts from zeroed launch counts and must launch every
kernel it reaches; a run through the plain versions must launch none.

The last line of standard output is ``{"ok": true, "device": {...}}``;
before it come the ``kernels`` JSON line and the card's name and power
limit as nvidia-smi gives them.  With no card it exits non-zero and prints
no result.
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


def phase_kernels() -> dict:
    """Every kernel against its plain version; timings at main-path shapes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.lane_scatter import (lane_scatter_add,
                                                  lane_scatter_set)
    from repro_torch.kernels.ranking_score import (ranking_scores,
                                                   ranking_victim_order)
    err = {"ranking_victim_order": 0.0, "ranking_scores": 0.0,
           "lane_scatter": 0.0}
    cases = 0
    for n in (N_DEPLOY, 1_000_003):
        for omega in (0.0, 1.0, 2.0):
            for density in (0.5, "sparse", 0.0):
                args = ranking_inputs(n, density, seed=cases)
                cases += 1
                f, idx, vals = ranking_victim_order(*args, omega=omega,
                                                    top=TOP)
                rf, ridx, rvals = ref.ranking_victim_order_ref(
                    *args, omega, TOP)
                if not (bitwise_equal(f, rf) and bitwise_equal(idx, ridx)
                        and bitwise_equal(vals, rvals)):
                    raise AssertionError(
                        f"ranking_victim_order != plain at n={n} "
                        f"omega={omega} density={density}: idx "
                        f"{idx.tolist()} vs {ridx.tolist()}, vals "
                        f"{vals.tolist()} vs {rvals.tolist()}")
                err["ranking_victim_order"] = max(
                    err["ranking_victim_order"],
                    float((f - rf).abs().max()))
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
    log(f"phase 1: ranking kernels bitwise equal to plain over {cases} "
        f"cases (n in 2^20, 1000003; omega 0/1/2; density 0.5/sparse/0)")

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

    # --- timings at the main path's shapes --------------------------------
    args = ranking_inputs(N_DEPLOY, 0.5, seed=1234)
    n = N_DEPLOY
    rank_bytes = n * (4 * 4 + 1 + 4)
    rank_flops = n * 16
    rank_bound = max(rank_bytes / HBM_BYTES_PER_S,
                     rank_flops / F32_FLOPS) * 1e3
    t = {
        "ranking_victim_order": (
            time_ms(lambda: ranking_victim_order(*args, omega=1.0, top=TOP)),
            time_ms(lambda: ref.ranking_victim_order_ref(*args, 1.0, TOP)),
            rank_bound + (TOP * 8) / HBM_BYTES_PER_S * 1e3, None),
        "ranking_scores": (
            time_ms(lambda: ranking_scores(*args, omega=1.0)),
            time_ms(lambda: ref.ranking_scores_ref(*args, 1.0)),
            rank_bound + 8 / HBM_BYTES_PER_S * 1e3, None),
    }
    # the main path's widest write: 12 f32 fields x 2 lanes of 2^20 objects
    rows = 24
    x = torch.zeros((rows, n), dtype=torch.float32, device="cuda")
    idx = torch.randint(0, n, (rows,), generator=g, device="cuda",
                        dtype=torch.int32)
    val = torch.randn(rows, generator=g, device="cuda")
    lanes_ix = torch.arange(rows, device="cuda")
    idx64 = idx.long()

    def library():
        x[lanes_ix, idx64] = val

    t["lane_scatter"] = (
        time_ms(lambda: lane_scatter_set(x, idx, val)),
        time_ms(lambda: ref.lane_scatter_set_ref(x, idx, val)),
        rows * (4 + 4 + 4) / HBM_BYTES_PER_S * 1e3,
        time_ms(library))
    for k, (ms, plain, bound, lib) in t.items():
        log(f"phase 1: {k}: {ms * 1e3:.2f} us/launch, plain "
            f"{plain * 1e3:.2f} us, bound {bound * 1e3:.3f} us"
            + ("" if lib is None else f", library {lib * 1e3:.2f} us"))
    return {k: dict(ms=v[0], plain_ms=v[1], bound_ms=v[2], library_ms=v[3],
                    max_abs_err=err[k]) for k, v in t.items()}


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
    log(f"{label}: {counts['requests'] / dt:.1f} req/s, "
        f"{counts['syncs'] / counts['requests']:.3f} syncs/request, "
        f"{counts['scoring_commits']} scoring commits, launches {lc}")
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
    timings at StableLM-2-1.6B's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
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

    # --- timings at StableLM-2-1.6B's shapes (bf16) ------------------------
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    elt = 2
    pre_flops = 2 * 2 * (s * (s + 1) // 2) * h * dh
    pre_bytes = 4 * b * s * h * dh * elt
    t = {"flash_attention": (
        time_ms(lambda: flash_attention(q, k, v, pos, pos), 20),
        time_ms(lambda: ref.flash_attention_ref(q, k, v, pos, pos), 5),
        max(pre_flops / BF16_FLOPS, pre_bytes / HBM_BYTES_PER_S) * 1e3,
        time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True), 20),
        "operations" if pre_flops / BF16_FLOPS
        > pre_bytes / HBM_BYTES_PER_S else "bytes")}
    caches_t = [(kc.transpose(1, 2).contiguous(),
                 vc.transpose(1, 2).contiguous()) for kc, vc in caches]
    qdt = qd.transpose(1, 2).contiguous()
    turn = [0]

    def rot(fn):
        def call():
            turn[0] = (turn[0] + 1) % 4
            return fn(turn[0])
        return call

    dec_bytes = (2 * b * s * h * dh + 2 * b * h * dh) * elt + s * 4
    dec_flops = 2 * 2 * s * h * dh
    t["decode_attention"] = (
        time_ms(rot(lambda i: decode_attention(qd, *caches[i], qpd, pos))),
        time_ms(rot(lambda i: ref.decode_attention_ref(qd, *caches[i], qpd,
                                                       pos)), 20),
        max(dec_bytes / HBM_BYTES_PER_S, dec_flops / BF16_FLOPS) * 1e3,
        time_ms(rot(lambda i: F.scaled_dot_product_attention(
            qdt, *caches_t[i]))),
        "bytes" if dec_bytes / HBM_BYTES_PER_S > dec_flops / BF16_FLOPS
        else "operations")
    for name, (ms, plain, bound, lib, by) in t.items():
        log(f"phase 4: {name} at StableLM shapes (B=1, 32 heads of 64, "
            f"{'S' if name == 'flash_attention' else 'Sc'}=2048, bf16): "
            f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, bound "
            f"{bound * 1e3:.2f} us ({by}), scaled_dot_product_attention "
            f"{lib * 1e3:.2f} us")
    return {name: dict(ms=ms, plain_ms=plain, bound_ms=bound, library_ms=lib,
                       bound_by=by,
                       max_abs_err=max(worst[(name, d)][0] for d in dts))
            for name, (ms, plain, bound, lib, by) in t.items()}


def phase_serve(launches: dict) -> None:
    """Full-width stablelm-1.6b behind the continuous batcher, kernels
    against plain versions; then the f32 logits check."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build, random_prompts, serve
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import make_serve_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, params = build(SERVE_ARCH)
    torch.cuda.synchronize()
    n = tf.n_params(params)
    log(f"phase 5: {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.d_head}, vocab {cfg.vocab}, "
        f"{n / 1e9:.3f} B parameters ({n * 2 / 1e9:.2f} GB bf16), "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    prompts = random_prompts(cfg, 8, 512, 2049)
    max_new = 32
    log(f"phase 5: 8 requests, prompt lengths {[len(p) for p in prompts]}, "
        f"{max_new} new tokens each, max_batch 4")
    runs = {}
    for mode in (True, "ref"):
        c = dataclasses.replace(cfg, use_kernel=mode)
        reset_launch_counts()
        torch.cuda.synchronize()
        r = serve(c, params, prompts, max_new)
        lc = launch_counts()
        runs[mode] = r
        log(f"phase 5: serve(use_kernel={mode!r}): {r['done']} requests, "
            f"prefill {r['prefill_tokens']} tokens in {r['prefill_s']:.3f} s "
            f"({r['prefill_tokens'] / r['prefill_s']:.1f} tok/s), decode "
            f"{r['decode_tokens']} tokens in {r['decode_s']:.3f} s "
            f"({r['decode_tokens'] / r['decode_s']:.1f} tok/s), wall "
            f"{r['wall_s']:.2f} s; launches flash_attention "
            f"{lc['flash_attention']}, decode_attention "
            f"{lc['decode_attention']}")
        if r["done"] != 8 or any(len(q.out) != max_new
                                 for q in r["requests"]):
            raise AssertionError(f"use_kernel={mode!r}: not every request "
                                 f"completed {max_new} tokens")
        if mode is True:
            for kname in ("flash_attention", "decode_attention"):
                if lc[kname] <= 0:
                    raise AssertionError(f"the serve path did not launch "
                                         f"{kname}")
            add_launches(launches, lc)
        elif any(lc.values()):
            raise AssertionError(f"the plain serve run launched {lc}")
    same = sum(a == b for qa, qb in zip(runs[True]["requests"],
                                        runs["ref"]["requests"])
               for a, b in zip(qa.out, qb.out))
    log(f"phase 5: greedy tokens equal to the plain run's: {same} of "
        f"{8 * max_new} ({same / (8 * max_new):.4f})")

    # --- f32 at full width: kernel path against plain path ----------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return [f32(v) for v in t] if isinstance(t, list) else t.float()

    p32 = f32(params)
    del params
    worst = 0.0
    steps = 16
    for i, prompt in enumerate(prompts[:2]):
        toks = torch.as_tensor(prompt[None, :], device="cuda")
        seq = {}
        for mode in ("ref", True):
            c = dataclasses.replace(cfg32, use_kernel=mode)
            prefill, decode = make_serve_steps(c)
            cache = tf.init_cache(c, 1, toks.shape[1] + steps + 1)
            logits, cache = prefill(p32, cache, {"tokens": toks})
            outs = [logits[0, -1]]
            feed = [int(torch.argmax(logits[0, -1]))] if mode == "ref" \
                else seq["ref"][1]
            for j in range(steps):
                tok = torch.tensor([[feed[j]]], device="cuda")
                logits, cache = decode(p32, cache, tokens=tok,
                                       pos0=toks.shape[1] + j)
                outs.append(logits[0, -1])
                if mode == "ref":
                    feed.append(int(torch.argmax(logits[0, -1])))
            seq[mode] = (torch.stack(outs), feed)
        want, got = seq["ref"][0], seq[True][0]
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        log(f"phase 5: f32 prompt {i} ({toks.shape[1]} tokens): prefill + "
            f"{steps} teacher-forced decode logits, kernels vs plain: max "
            f"|diff| / max |logit| = {rel:.3e}")
        if not rel <= 1e-3 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"f32 logits of the kernel path differ from "
                                 f"the plain path by {rel} of max |logit|")
    log(f"phase 5: f32 full-width check passed (max {worst:.3e} <= 1e-3 of "
        f"max |logit|)")


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

    timings = phase_kernels()
    timings.update(phase_attention())
    launches = {}
    phase_paper(launches)
    phase_deploy(args.requests, launches)
    phase_serve(launches)
    log(f"launches over the main-path runs of phases 2-3 and 5: {launches}")
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
