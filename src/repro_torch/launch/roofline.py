"""Roofline analysis over the dry-run records: the counterpart of the JAX
package's ``launch/roofline.py``, with an NVIDIA H100's constants in place
of the TPU v5e's.

Per (arch, shape, mesh) cell, from the recorded per-device cost and
collectives (:mod:`repro_torch.launch.dryrun`), the three per-device
roofline terms:

    compute    = FLOPs per device / PEAK_FLOPS
    memory     = bytes per device / HBM_BW
    collective = wire bytes per device / LINK_BW

plus MODEL_FLOPS (6 N D train / 2 N_active D inference + attention term)
and the usefulness ratio MODEL / counted that exposes remat and redundant
compute.  The constants, for one H100 SXM5 80GB at its 700 W limit:

- PEAK_FLOPS = 989.4e12 bf16 dense FLOP/s (NVIDIA H100 data sheet, SXM5,
  tensor cores without sparsity);
- HBM_BW = 3.35e12 B/s (the same data sheet, HBM3);
- LINK_BW = 50e9 B/s: a 16-wide ``model`` ring spans two 8-GPU NVLink
  nodes, so its slowest hop is a node's InfiniBand NDR link, 400 Gb/s =
  50 GB/s a GPU (one ConnectX-7 a GPU in a DGX H100), not NVLink's
  450 GB/s each way.  Every collective is priced at that hop.

These are predictions from data-sheet rates, not measurements.
"""
from __future__ import annotations

import argparse
import json

from .dryrun import RESULTS

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 50e9


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs per step (global, forward+backward for train)."""
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * shape.seq_len
    d_att = cfg.n_layers * cfg.n_heads * cfg.d_head
    if shape.kind == "train":
        mm = 6.0 * n_active * tokens
        window = cfg.sliding_window or shape.seq_len
        ctx = min(window, shape.seq_len)
        att = 6.0 * tokens * ctx * 0.5 * 2.0 * d_att
        return mm + att
    if shape.kind == "prefill":
        window = cfg.sliding_window or shape.seq_len
        ctx = min(window, shape.seq_len)
        return 2.0 * n_active * tokens + 4.0 * tokens * ctx * 0.5 * d_att
    b = shape.global_batch
    window = cfg.sliding_window or shape.seq_len
    ctx = min(window, shape.seq_len)
    if cfg.is_recurrent and cfg.family == "ssm":
        ctx = 0
    return 2.0 * n_active * b + 4.0 * b * ctx * d_att


def analyze(rec: dict) -> dict:
    """The roofline row of one ``ok`` record."""
    from ..configs import registry
    from ..configs.base import SHAPES

    cfg = registry.get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = rec.get("devices") or (512 if rec["mesh"] == "multi" else 256)
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes"]
    wire_dev = rec["collectives"]["wire_bytes"]["total"]
    t_comp = flops_dev / PEAK_FLOPS
    t_mem = bytes_dev / HBM_BW
    t_coll = wire_dev / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    counted = flops_dev * chips
    t_bound = max(terms.values())
    frac = (mf / chips / PEAK_FLOPS) / t_bound if t_bound > 0 else 0.0
    return dict(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        peak_gib=rec["memory"]["peak_bytes"] / 2**30,
        t_compute_ms=t_comp * 1e3, t_memory_ms=t_mem * 1e3,
        t_collective_ms=t_coll * 1e3, bottleneck=bottleneck,
        model_gflops=mf / 1e9, hlo_global_gflops=counted / 1e9,
        useful_ratio=(mf / counted) if counted > 0 else 0.0,
        roofline_frac=frac, calibrated=bool(rec.get("calibrated", True)),
        ok=rec.get("ok", False), tag=rec.get("tag", ""),
    )


def load_all(tag: str = "", results=RESULTS) -> list[dict]:
    out = []
    for p in sorted(results.glob("*.json")):
        rec = json.loads(p.read_text())
        if not rec.get("ok"):
            out.append(dict(arch=rec["arch"], shape=rec["shape"],
                            mesh=rec["mesh"], ok=False,
                            error=rec.get("error", "?")[:80]))
            continue
        if rec.get("tag", "") != tag:
            continue
        out.append(analyze(rec))
    return out


def table(rows: list[dict], mesh: str = "single") -> str:
    hdr = ("| arch | shape | peak GiB/dev | compute ms | memory ms | "
           "coll ms | bottleneck | useful | roofline |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if not r.get("ok", True) or r["mesh"] != mesh:
            continue
        star = "" if r.get("calibrated") else "*"
        lines.append(
            f"| {r['arch']} | {r['shape']}{star} | {r['peak_gib']:.2f} | "
            f"{r['t_compute_ms']:.2f} | {r['t_memory_ms']:.2f} | "
            f"{r['t_collective_ms']:.2f} | {r['bottleneck']} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_frac']:.1%} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = load_all(tag=args.tag)
    if args.csv:
        import csv
        import sys
        ok_rows = [r for r in rows if r.get("ok", True)]
        if ok_rows:
            w = csv.DictWriter(sys.stdout, fieldnames=list(ok_rows[0]))
            w.writeheader()
            w.writerows(ok_rows)
    else:
        print(table(rows, mesh=args.mesh))
        bad = [r for r in rows if not r.get("ok", True)]
        if bad:
            print(f"\nFAILED cells: {len(bad)}")
            for r in bad:
                print(f"  {r['arch']}@{r['shape']}@{r['mesh']}: {r['error']}")


if __name__ == "__main__":
    main()
