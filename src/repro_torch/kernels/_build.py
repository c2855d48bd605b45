"""Build and load the port's CUDA kernels (nvcc into a shared library with a
plain C interface, loaded with ctypes).

Each ``csrc/<name>.cu`` compiles to its own ``lib<name>-<hash>.so`` under
``kernels/build/`` (listed in ``.gitignore``), at first use.  The hash
covers the source and the flags, so an edited source rebuilds and a stale
library is never loaded (the hash also covers the shared ``csrc/*.cuh``
headers).  :func:`build_all` starts one ``nvcc`` per source,
all at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float

# C entry points: name -> argtypes.  Every one returns cudaGetLastError().
SIGNATURES = {
    "ranking_score": {
        "rank_select": [_P] * 5 + [_F32, _I64, _INT] + [_P] * 6,
    },
    "lane_scatter": {
        "lane_scatter": [_P, _P, _P, _P, _I64, _I64, _INT, _INT, _P],
        "lane_scatter_batch": [_P, _INT, _P],
    },
    "flash_attention": {
        "flash_attention": [_P] * 6 + [_INT] * 6 + [_I64] * 9
        + [_F32, _INT, _F32, _INT, _INT, _P],
    },
    "decode_attention": {
        "decode_attention": [_P] * 8 + [_INT] * 8 + [_I64] * 8
        + [_F32, _INT, _F32, _INT, _INT, _P],
    },
    "gla_chunk": {
        "gla_chunk": [_P] * 14 + [_INT] * 6 + [_I64] * 9
        + [_F32, _INT, _INT, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    cands += [Path(which)] if which else []
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(proc, tmp, out)`` or None."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)       # atomic: a concurrent build never sees half


def build_all(names=None) -> dict[str, Path]:
    """Compile every (or the named) kernel source, all nvcc runs started
    together; returns each library's path."""
    names = list(SIGNATURES) if names is None else list(names)
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        _finish(n, job)
    return {n: lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name`` (built on first use),
    with ``argtypes``/``restype`` set for every entry point."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, args in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
