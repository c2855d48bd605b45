"""The multi-device sweep fabric: a grid's lanes split over a device mesh.

:func:`repro_torch.core.sweep_grid` and :func:`repro_torch.core.
sweep_hier_grid` route ``devices=`` / ``mesh=`` here.  The replay engine is
a host loop that keeps its device mostly idle, so shards in one host
thread would gain nothing from more devices; instead each mesh device gets
a worker process (``multiprocessing`` ``spawn``) that runs its own engine
over its block of lanes:

- a flat grid's lanes (policy-major, as the in-process grid flattens them)
  and a hierarchy grid's points are split into contiguous blocks in mesh
  order, one block a device; a device whose block is empty starts no
  worker, so there are no dead lanes;
- a worker receives the requests as host numpy columns and its block's
  lane specs, and sends back host numpy results, the engines' counters,
  its kernels' launch counts and its start-up seconds (never a CUDA
  tensor);
- the caller gathers the blocks back into the in-process layout.

This module knows nothing of the engines: the caller
(:mod:`repro_torch.core.sweep`) passes the task a worker runs, the same
engine loop it runs in process, with host output.

Lanes never interact, so device count and lane-to-device assignment are
bitwise invisible in every result field.  A worker runs with the caller's
``torch`` thread count.  On a card, the caller builds every kernel before
it starts the workers.  A worker that raises fails the call with the
worker's traceback; every worker is joined, or terminated, before the
call returns.  Nothing falls back to fewer devices, to the in-process
path or to the CPU.

Importing this module never initialises CUDA.
"""
from __future__ import annotations

import multiprocessing
import time
import traceback
from multiprocessing.connection import wait

import torch

from .mesh import Mesh, make_data_mesh

__all__ = ["FabricWorkerError", "resolve_fabric", "lane_blocks",
           "run_shards"]


class FabricWorkerError(RuntimeError):
    """A fabric worker raised or died; the message holds its traceback."""


def resolve_fabric(devices: int | None = None, mesh: Mesh | None = None,
                   device=None) -> Mesh | None:
    """Map ``devices=`` / ``mesh=`` onto a mesh, or None for the
    in-process path (``devices`` None or 1 with no mesh).

    An explicit ``mesh`` always routes through the fabric, even with one
    device, and must carry a ``data`` axis; ``device``, when given, must
    name the mesh's device type.  ``devices=d`` builds a ``data`` mesh
    over the first ``d`` CUDA devices, or over ``d`` CPU entries when
    ``device="cpu"``."""
    from .._device import resolve_device
    if mesh is not None:
        if devices is not None:
            raise ValueError("pass either devices= or mesh=, not both")
        if "data" not in mesh.axis_names:
            raise ValueError(
                f"fabric mesh needs a 'data' axis (the lane-splitting "
                f"axis); got axes {mesh.axis_names}")
        kind = mesh.devices[0].type
        if device is not None and torch.device(device).type != kind:
            raise ValueError(f"device={device!r} but the mesh holds "
                             f"{kind} devices")
        if kind == "cuda":
            resolve_device("cuda")
            n = torch.cuda.device_count()
            bad = [str(d) for d in mesh.devices if (d.index or 0) >= n]
            if bad:
                raise ValueError(f"the mesh names {bad} but only {n} CUDA "
                                 f"device(s) are visible")
        return mesh
    if devices is None:
        return None
    d = int(devices)
    if d < 1:
        raise ValueError(f"devices={devices} must be >= 1")
    if d == 1:
        return None
    dev = resolve_device(device)
    if dev.type != "cuda":
        return make_data_mesh(d, [dev] * d)
    n = torch.cuda.device_count()
    if d > n:
        raise ValueError(f"devices={d} but only {n} CUDA device(s) are "
                         f"visible")
    return make_data_mesh(d)


def lane_blocks(n: int, d: int) -> list[slice]:
    """``n`` lanes in ``d`` contiguous blocks, in order, sizes differing by
    at most one (the first blocks the larger)."""
    q, r = divmod(n, d)
    out, lo = [], 0
    for k in range(d):
        hi = lo + q + (k < r)
        out.append(slice(lo, hi))
        lo = hi
    return out


def _worker(conn, task, device: str, payload: tuple, threads: int) -> None:
    """A worker's entry: run ``task(device, *payload)`` and send back
    ("ok", its output, its launch counts, the time its device was ready)
    or ("error", the traceback)."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
            torch.cuda.synchronize(dev)
        ready = time.time()
        from ..kernels import launch_counts, reset_launch_counts
        reset_launch_counts()
        out = task(dev, *payload)
        conn.send(("ok", out, launch_counts(), ready))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def _add(counters: dict, stats: dict) -> None:
    for k, v in stats.items():
        counters[k] = counters.get(k, 0) + v


def run_shards(mesh: Mesh, task, payloads: list,
               counters: dict | None = None) -> list:
    """Run ``task(device, *payloads[k])`` in a worker process on mesh
    device ``k`` (a None payload starts no worker); returns the outputs'
    first items in mesh order (None where no worker ran).

    Each output is ``(result, stats)``; ``counters``, when given, sums
    every worker's ``stats`` but ``requests`` (every worker replays the
    same requests, so they count once), its kernels' launches under
    ``"launches"`` (a dict by kernel), the number of workers under
    ``"workers"`` and their start-up seconds (spawn to a ready device)
    under ``"worker_start_s"``."""
    if any(d.type == "cuda" for d in mesh.devices):
        from ..kernels import _build
        _build.build_all()
    ctx = multiprocessing.get_context("spawn")
    threads = torch.get_num_threads()
    procs, pending = [], {}
    try:
        for k, (dev, payload) in enumerate(zip(mesh.devices, payloads)):
            if payload is None:
                continue
            recv, send = ctx.Pipe(duplex=False)
            t0 = time.time()
            p = ctx.Process(target=_worker, daemon=True,
                            args=(send, task, str(dev), payload, threads))
            p.start()
            send.close()
            procs.append((p, recv))
            pending[recv] = (k, p, t0)
        outs = [None] * len(mesh.devices)
        first = True
        while pending:
            for r in wait(list(pending)):
                k, p, t0 = pending.pop(r)
                try:
                    msg = r.recv()
                except EOFError:
                    p.join(timeout=10)
                    raise FabricWorkerError(
                        f"fabric worker {k} on {mesh.devices[k]} exited "
                        f"(code {p.exitcode}) without a result") from None
                if msg[0] != "ok":
                    raise FabricWorkerError(
                        f"fabric worker {k} on {mesh.devices[k]} "
                        f"raised:\n{msg[1]}")
                _, (result, stats), launches, ready = msg
                outs[k] = result
                if counters is not None:
                    stats = dict(stats)
                    requests = stats.pop("requests", 0)
                    if first:
                        stats["requests"] = requests
                        first = False
                    _add(counters, stats)
                    _add(counters.setdefault("launches", {}), launches)
                    _add(counters, {"workers": 1,
                                    "worker_start_s": ready - t0})
        return outs
    finally:
        for p, r in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
            r.close()
