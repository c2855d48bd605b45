"""Paper Fig. 3: popularity and inter-arrival statistics of the four
surrogate traces (the generators' shape calibration)."""
from __future__ import annotations

import argparse

import numpy as np

from ..data.traces import SURROGATES, surrogate_trace
from .common import emit


def run(device=None) -> list[dict]:
    rows = []
    for name in SURROGATES:
        tr = surrogate_trace(name, device=device)
        objs = tr.objs.cpu().numpy()
        times = tr.times.cpu().numpy()
        sizes = tr.sizes.cpu().numpy()
        counts = np.bincount(objs, minlength=tr.n_objects).astype(float)
        counts.sort()
        counts = counts[::-1]
        nz = counts[counts > 0]
        # Zipf slope from the top decade of the rank-frequency curve
        top = nz[: max(len(nz) // 10, 10)]
        ranks = np.arange(1, len(top) + 1)
        slope = -np.polyfit(np.log(ranks), np.log(top), 1)[0]
        gaps = np.diff(times)
        rows.append(dict(
            trace=name,
            n_objects=tr.n_objects,
            n_requests=tr.n_requests,
            zipf_slope=round(float(slope), 3),
            top1_share=round(float(counts[0] / counts.sum()), 4),
            mean_interarrival_ms=round(float(gaps.mean() * 1e3), 4),
            cv_interarrival=round(float(gaps.std() / gaps.mean()), 3),
            mean_size_mb=round(float(sizes.mean()), 3),
            footprint_mb=round(float(sizes.sum()), 1),
        ))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    emit(run(device=args.device), "fig3_trace_stats")


if __name__ == "__main__":
    main()
