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
   kernel path held against the plain path and the ``evict_top=0`` path.

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
    launches = {}
    phase_paper(launches)
    phase_deploy(args.requests, launches)
    log(f"launches over the main-path runs of phases 2-3: {launches}")

    meta = {
        "ranking_victim_order": ("kernels/csrc/ranking_score.cu",
                                 "src/repro/kernels/ranking_score.py:114"),
        "ranking_scores": ("kernels/csrc/ranking_score.cu",
                           "src/repro/kernels/ranking_score.py:43"),
        "lane_scatter": ("kernels/csrc/lane_scatter.cu",
                         "src/repro/kernels/lane_scatter.py:80"),
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
            "bound_by": "bytes", "library_ms": tm["library_ms"]})
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
