"""Reading a ``torch.profiler`` trace of the measured window: the device's
busy intervals, the idle gaps between them labelled by what the host was
doing, and the device operations that took most time.

The window is the host span ``bench.window`` that the harness records
around it; device times are clipped to it.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list          # (name, start_s, end_s) of each device event, by start
    gaps: list            # (start_s, end_s) of each idle gap, by start
    host: tuple           # (starts, ends, names) of the host events, arrays


# Events off the host that do not occupy the card: the profiler's
# device-side copies of user spans (``is_user_annotation``) and its
# synchronisation markers.  Every other event off the host (kernels,
# copies, sets) is the card's work.
NOT_BUSY = re.compile(r"^(Event Sync|Stream Sync|Context Sync|Device Sync"
                      r"|Stream Wait Event)\b")


def _is_host(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] == "CPU"


def _is_device(e) -> bool:
    return (not _is_host(e) and not e.is_user_annotation()
            and not NOT_BUSY.match(e.name()))


def merge(intervals: list) -> list:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def build(window: tuple, device: list, host: list) -> Trace:
    """A trace from the window ``(start_s, end_s)``, device events and host
    events given as ``(name, start_s, end_s)``."""
    w0, w1 = window
    dev = sorted(((n, max(s, w0), min(e, w1)) for n, s, e in device
                  if e > w0 and s < w1), key=lambda x: x[1])
    busy = merge([(s, e) for _, s, e in dev])
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    names = [n for n, _, _ in host]
    starts = np.array([s for _, s, _ in host], dtype=np.float64)
    ends = np.array([e for _, _, e in host], dtype=np.float64)
    return Trace(window_s=w1 - w0, busy_s=sum(e - s for s, e in busy),
                 device=dev, gaps=gaps, host=(starts, ends, names))


def from_profiler(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile`` whose window is
    the ``bench.window`` span (times in seconds from the window's start)."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.end_ns())
        if _is_device(e):
            device.append(item)
        elif _is_host(e):
            if item[0] == WINDOW_SPAN:
                window = item[1:]
            host.append(item)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    base = window[0]

    def sec(items):
        return [(n, (s - base) * 1e-9, (e - base) * 1e-9)
                for n, s, e in items]
    return build((0.0, (window[1] - base) * 1e-9), sec(device), sec(host))


def host_at(tr: Trace, t: float) -> str:
    """The innermost host event open at time ``t``, or ``idle host``."""
    starts, ends, names = tr.host
    if not len(starts):
        return "idle host"
    hit = np.nonzero((starts <= t) & (ends >= t))[0]
    hit = [i for i in hit if names[i] != WINDOW_SPAN]
    if not hit:
        return "idle host"
    return names[min(hit, key=lambda i: ends[i] - starts[i])]


def short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The ``n`` device operations that took most time, summed by name,
    and the ``n`` longest idle gaps by what the host was doing."""
    by_name: dict[str, float] = {}
    for name, s, e in tr.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(tr.gaps, key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[short(k), v] for k, v in ops],
            "idle_gaps": [[short(host_at(tr, (s + e) / 2)), e - s]
                          for s, e in gaps]}
