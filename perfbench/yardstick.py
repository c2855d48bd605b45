"""The benchmark's own arithmetic: seeds, the chip's peaks, and the
operations and bytes of the work a window did.

Nothing here imports the program.  The sizes come from the family's
reference module (``reference/<family>.py``, named by a configuration
file's ``reference`` key): its ``geometry(cfg)`` gives the heads, the
window, and the matrix parameters that act on each token (a block's, the
head's).  From them:

- visible (query, key) pairs of a causal prefill of ``s`` positions under
  an optional sliding window (no sink: the benchmark's configurations have
  none), in closed form;
- model FLOPs of a prefill (2 x the blocks' matrix parameters x tokens,
  4 x visible pairs x d_head x q heads for attention, the head at the last
  position only) and of a train step (6 x (the blocks' + the head's
  parameters) x tokens, 12 x visible pairs x d_head x q heads: forward and
  backward, recomputation not counted);
- the attention kernel's bound: the larger of its operations (q.k and p.v
  over the visible pairs) at the bf16 tensor rate and its bytes (q, k, v,
  out and the positions, each once) at the memory rate.  The same
  arithmetic as the program's ``figures/bench_kernels.attention_bound``,
  with the pairs counted in closed form.
"""
from __future__ import annotations

import hashlib
import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks by the name the card reports (NVIDIA H100 data sheet, SXM5,
# dense rates without sparsity, at the full 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes_s": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    """The peaks of a card by its ``torch.cuda.get_device_name()``, or None
    for a card the table does not know (its shares are then not read)."""
    return PEAKS.get(kind)


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed`` and tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def family(cfg: dict):
    """The reference module of a configuration's family."""
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def geometry(cfg: dict) -> dict:
    """The sizes the counts need, from a configuration file."""
    return family(cfg).geometry(cfg)


def visible_pairs(s: int, window: int = 0) -> int:
    """Causal (query, key) pairs of positions 0..s-1 against themselves;
    with a window w a query sees the w keys up to and including its own."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def prefill_flops(g: dict, s: int) -> float:
    """Model FLOPs of one prefill of ``s`` tokens (batch 1)."""
    pairs = visible_pairs(s, g["window"])
    return (2.0 * g["layers"] * g["matrix_params"] * s
            + 4.0 * g["layers"] * pairs * g["dh"] * g["h"]
            + 2.0 * g["head_params"])


def train_flops(g: dict, rows: int, s: int) -> float:
    """Model FLOPs of one train step over ``rows`` sequences of ``s``."""
    pairs = visible_pairs(s, g["window"]) * rows
    params = g["layers"] * g["matrix_params"] + g["head_params"]
    return (6.0 * params * rows * s
            + 12.0 * g["layers"] * pairs * g["dh"] * g["h"])


def attention_bound(g: dict, rows: int, s: int, peak: dict,
                    elem_bytes: int = 2) -> tuple[float, str]:
    """(seconds, what bounds it) of one attention launch over ``rows`` x
    ``s`` positions, queries and keys alike."""
    pairs = visible_pairs(s, g["window"]) * rows * g["h"]
    flops = 2 * 2 * pairs * g["dh"]
    nbytes = ((2 * rows * s * g["h"] + 2 * rows * s * g["kv"]) * g["dh"]
              * elem_bytes + 2 * s * 4)
    ops_s = flops / peak["bf16_flops"]
    bytes_s = nbytes / peak["hbm_bytes_s"]
    return max(ops_s, bytes_s), ("operations" if ops_s > bytes_s
                                 else "bytes")
