"""Bounded-memory streaming quantile estimation for the serving benchmark.

A copy of the JAX package's ``core/percentile.py`` (numpy only there too),
so the port's serving benchmark reports the same tail numbers bit for bit.
:class:`StreamingQuantile` is a DDSketch-style log-bucketed histogram with
an exact small-sample buffer:

* **Exact below ``exact_n``**: while the total count fits the buffer the
  estimator IS ``np.percentile`` (linear interpolation), bit for bit.
* **Relative-error bound above**: past ``exact_n`` every value lands in a
  geometric bucket ``[g^i, g^(i+1))`` with ``g = (1+rel_err)/(1-rel_err)``;
  reporting the bucket's geometric midpoint guarantees
  ``|q_est - q_true| <= q_true * rel_err / (1 - rel_err)`` for any
  quantile of the values inside the histogram's dynamic range (values are
  clamped to ``[min_value, max_value]``; exact zeros get a bucket of their
  own).
* **Exactly associative merges**: the spill rule is *count*-based (all
  buffered values move to their buckets as soon as the **total** count
  exceeds ``exact_n``), so every value's final bucket depends only on the
  multiset of inserted values, never on chunking: merging chunk sketches
  in any grouping gives the state of one monolithic pass.

Memory: ``n_buckets = ceil(ln(max/min) / ln(g))`` int64 counters (about
11 KB at the defaults) plus the ``exact_n`` f64 buffer.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["StreamingQuantile", "QuantileSummary"]


@dataclasses.dataclass(frozen=True)
class QuantileSummary:
    """The headline tail numbers the serving benchmark emits per config."""

    count: int
    p50: float
    p95: float
    p99: float
    p999: float
    mean: float
    max: float

    def as_dict(self, scale: float = 1.0, ndigits: int = 4) -> dict:
        r = lambda v: round(v * scale, ndigits)
        return dict(count=self.count, p50=r(self.p50), p95=r(self.p95),
                    p99=r(self.p99), p999=r(self.p999), mean=r(self.mean),
                    max=r(self.max))


class StreamingQuantile:
    """Streaming quantile sketch: exact when small, rel-err-bounded at scale.

    All instances participating in a :meth:`merge` must share identical
    ``(rel_err, min_value, max_value, exact_n)`` — the bucket geometry is
    the merge contract.
    """

    def __init__(self, rel_err: float = 0.01, min_value: float = 1e-7,
                 max_value: float = 1e7, exact_n: int = 512):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err={rel_err} must be in (0, 1)")
        if not 0.0 < min_value < max_value:
            raise ValueError("need 0 < min_value < max_value")
        self.rel_err = float(rel_err)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.exact_n = int(exact_n)
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self.gamma)
        self.n_buckets = int(
            math.ceil(math.log(max_value / min_value) / self._log_gamma)) + 1
        self.counts = np.zeros(self.n_buckets, np.int64)
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buf: list[float] = []

    # --- ingest ---------------------------------------------------------
    def _bucket_of(self, v: np.ndarray) -> np.ndarray:
        """Bucket index for positive values, clamped to the dynamic range."""
        v = np.clip(v, self.min_value, self.max_value)
        idx = np.floor(np.log(v / self.min_value) / self._log_gamma)
        return np.clip(idx.astype(np.int64), 0, self.n_buckets - 1)

    def _spill(self) -> None:
        if not self._buf:
            return
        vals = np.asarray(self._buf, np.float64)
        self._buf = []
        zeros = int(np.count_nonzero(vals <= 0.0))
        self.zero_count += zeros
        pos = vals[vals > 0.0]
        if pos.size:
            np.add.at(self.counts, self._bucket_of(pos), 1)

    def add(self, values) -> "StreamingQuantile":
        """Insert a scalar or array of non-negative values (negatives are
        clamped to the zero bucket — latencies cannot be negative, but a
        float underflow must not crash a million-request run)."""
        vals = np.atleast_1d(np.asarray(values, np.float64))
        if vals.size == 0:
            return self
        self.count += int(vals.size)
        self.sum += float(vals.sum())
        self.min = min(self.min, float(vals.min()))
        self.max = max(self.max, float(vals.max()))
        self._buf.extend(vals.tolist())
        if self.count > self.exact_n:
            self._spill()
        return self

    def merge(self, other: "StreamingQuantile") -> "StreamingQuantile":
        """Merge ``other`` into ``self`` (returns self).  Exactly
        associative and commutative in the resulting state — see the
        module docstring for why the spill rule makes this true."""
        geo = (self.rel_err, self.min_value, self.max_value, self.exact_n)
        if geo != (other.rel_err, other.min_value, other.max_value,
                   other.exact_n):
            raise ValueError("merging sketches with different geometry")
        self.counts += other.counts
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self._buf.extend(other._buf)
        if self.count > self.exact_n:
            self._spill()
        return self

    # --- query ----------------------------------------------------------
    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        if self._buf:             # exact regime: count <= exact_n
            return float(np.percentile(np.asarray(self._buf, np.float64),
                                       q * 100.0))
        rank = q * (self.count - 1)
        # cumulative walk: zero bucket first, then the geometric buckets
        if rank < self.zero_count:
            return max(0.0, self.min)
        cum = self.zero_count
        for i, c in enumerate(self.counts):
            cum += int(c)
            if rank < cum:
                mid = self.min_value * self.gamma ** (i + 0.5)
                return float(min(max(mid, self.min), self.max))
        return self.max

    def quantiles(self, qs) -> list[float]:
        return [self.quantile(q) for q in qs]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def summary(self) -> QuantileSummary:
        p50, p95, p99, p999 = self.quantiles((0.5, 0.95, 0.99, 0.999))
        return QuantileSummary(count=self.count, p50=p50, p95=p95, p99=p99,
                               p999=p999, mean=self.mean,
                               max=self.max if self.count else math.nan)
