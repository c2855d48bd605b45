"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- :mod:`ranking_score`    eq.-16 scores + victim selection (``csrc/ranking_score.cu``)
- :mod:`lane_scatter`     per-lane point writes into ``[L, N]`` state; a batch of them in one launch (``csrc/lane_scatter.cu``)
- :mod:`point_update`     the replay's serves, commits and cached-bit writes at one object a lane, queued and applied in one launch a flush (``csrc/point_update.cu``)
- :mod:`flash_attention`  prefill attention (``csrc/flash_attention.cu``)
- :mod:`decode_attention` one-token attention over a KV cache (``csrc/decode_attention.cu``)
- :mod:`gla_chunk`        chunked gated linear attention for mLSTM / Mamba heads (``csrc/gla_chunk.cu``)
- :mod:`ref`              the plain PyTorch versions (CPU path, on-card oracle)
- :mod:`_build`           nvcc build + ctypes loading, at first use
"""
from . import (decode_attention, flash_attention, gla_chunk, lane_scatter,
               point_update, ranking_score)
from .lane_scatter import (lane_scatter_add, lane_scatter_batch,
                           lane_scatter_set)
from .ranking_score import ranking_scores, ranking_victim_order

_COUNTERS = (ranking_score.launches, lane_scatter.launches,
             point_update.launches,
             flash_attention.launches, decode_attention.launches,
             gla_chunk.launches)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


__all__ = ["lane_scatter_add", "lane_scatter_batch", "lane_scatter_set",
           "ranking_scores", "ranking_victim_order", "launch_counts",
           "reset_launch_counts"]
