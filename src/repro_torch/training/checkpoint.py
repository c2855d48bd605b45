"""Crash-safe checkpoints in the JAX package's layout, so either package
reads the other's files (``training/checkpoint.py`` there):

    <dir>/step_<N>.tmp/            # written first
        manifest.json              # {"step", "leaves": {path: {file,
                                   #  shape, dtype}}}
        arr_<k>.npy                # one file per leaf, in sorted path order
    <dir>/step_<N>/                # atomic rename on completion
    <dir>/LATEST                   # text file, updated last

A leaf's path joins its dict keys, list indices and NamedTuple fields with
``/``, as the reference's does.  Its dtype is recorded by numpy's name
(``"bfloat16"``, not ``"torch.bfloat16"``); numpy has no bf16 or fp8, so
those leaves are written as their ``uint16``/``uint8`` bit views, as the
reference writes them.  ``save`` copies every leaf to the host before it
returns (a fresh copy, also of a CPU tensor), so in-place updates after it
never reach a write still in flight; the files are written on a thread
unless ``block``.  ``restore`` puts each leaf on the device of the
template's leaf (or ``device``), or, given ``shardings``, restores onto a
mesh: each rank reads its own slice of each saved leaf (a memory-mapped
read) and gets a DTensor with the leaf's placements, whatever mesh saved
it (elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

# leaves numpy cannot hold, written as bit views: dtype -> (name, view)
_VIEW_AS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
            torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
            torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_VIEW_BACK = {name: (dt, view) for dt, (name, view, _) in _VIEW_AS.items()}


def _flatten(tree: Any, prefix="") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif hasattr(tree, "_fields"):              # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(template: Any, flat: dict[str, Any], prefix="") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}/{k}")
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_into(getattr(template, k), flat, f"{prefix}/{k}")
            for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}/{i}")
            for i, v in enumerate(template))
    return flat[prefix]


def to_host(x) -> tuple[np.ndarray, str]:
    """(a fresh host array, the logical dtype name) of a leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype in _VIEW_AS:
            name, view, npv = _VIEW_AS[t.dtype]
            arr = t.view(view).to("cpu", copy=True).numpy().view(npv)
            return arr, name
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(x)
    return arr, str(arr.dtype)


def from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype in _VIEW_BACK:
        dt, view = _VIEW_BACK[dtype]
        t = torch.from_numpy(arr.view(np.int16 if view == torch.int16
                                      else np.uint8)).view(dt)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = False) -> None:
        """Copy every leaf to the host, then write them (on a thread
        unless ``block``); the tensors are free to change once this
        returns."""
        self.wait()
        host = {k: to_host(v) for k, v in _flatten(tree).items()}

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {}
            for i, (k, (v, logical)) in enumerate(sorted(host.items())):
                fn = f"arr_{i}.npy"
                np.save(tmp / fn, v)
                manifest[k] = {"file": fn, "shape": list(v.shape),
                               "dtype": logical}
            (tmp / "manifest.json").write_text(json.dumps(
                {"step": step, "leaves": manifest}))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            (self.dir / "LATEST.tmp").write_text(str(step))
            (self.dir / "LATEST.tmp").rename(self.dir / "LATEST")
            self._gc()

        if block:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if p.is_dir() and not p.name.endswith(".tmp")]

    def latest_step(self) -> int | None:
        f = self.dir / "LATEST"
        if not f.exists():
            steps = self.steps()
            return max(steps) if steps else None
        s = int(f.read_text().strip())
        return s if (self.dir / f"step_{s}").exists() else None

    def restore(self, step: int, template: Any, device=None,
                shardings: Any | None = None) -> Any:
        """Load into the structure of ``template``; each leaf goes to
        ``device`` or else to the template leaf's device (the CPU for a
        leaf that is not a tensor).  ``shardings``, a tree like
        ``template`` of ``(DeviceMesh, spec)`` pairs (a spec of
        :mod:`repro_torch.sharding.specs`), restores
        every leaf as a DTensor on its mesh, from this rank's slice of the
        saved array alone."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]
        flat_s = _flatten_pairs(shardings) if shardings is not None else {}
        flat = {}
        for k, t in _flatten(template).items():
            meta = manifest[k]
            sh = flat_s.get(k)
            arr = np.load(d / meta["file"],
                          mmap_mode="r" if sh is not None else None)
            want = getattr(t, "shape", None)
            if want is not None and tuple(arr.shape) != tuple(want):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{arr.shape} vs {tuple(want)}")
            if sh is not None:
                flat[k] = _restore_shard(arr, meta["dtype"], *sh)
                continue
            dev = device if device is not None else getattr(t, "device",
                                                            "cpu")
            flat[k] = from_host(arr, meta["dtype"], dev)
        return _unflatten_into(template, flat)


def _flatten_pairs(tree: Any, prefix="") -> dict[str, Any]:
    """``_flatten`` with ``(mesh, spec)`` pairs as leaves."""
    if isinstance(tree, tuple) and len(tree) == 2 and hasattr(
            tree[0], "mesh_dim_names"):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_pairs(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flatten_pairs(getattr(tree, k), f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_pairs(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _restore_shard(arr: np.ndarray, dtype: str, mesh, spec):
    """This rank's slice of the saved ``arr`` as a DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from ..sharding.specs import placements
    pl = placements(mesh, spec)
    shape, offset = compute_local_shape_and_global_offset(
        tuple(arr.shape), mesh, pl)
    sl = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    dev = mesh.device_type
    if dev == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    local = from_host(np.array(arr[sl]), dtype, dev)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(arr.shape),
                              stride=torch.empty(arr.shape,
                                                 device="meta").stride())
