"""PyTorch + CUDA port of the delayed-hit caching reproduction.

Entry points take ``device=None``, which means the CUDA card; with no card
they raise unless the caller passes ``device="cpu"``, where every kernel
runs its plain PyTorch version.  The package imports neither JAX nor the
JAX package (``repro``).
"""
from ._device import resolve_device
from .core import (POLICIES, PolicyParams, SimResult, Trace,
                   latency_improvement, make_trace, simulate)

__all__ = ["resolve_device", "POLICIES", "PolicyParams", "SimResult",
           "Trace", "latency_improvement", "make_trace", "simulate"]
