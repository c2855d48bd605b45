"""Trace generators (paper §5.2-5.3) and real-world trace ingestion.

Synthetic: requests over N objects with Zipf popularity, sizes uniform on
[size_min, size_max] MB (integer-floored), miss latency L + c * size with
Exponential realizations, and Poisson or Pareto arrivals.  Draws come from
an explicit ``torch.Generator``; they match the JAX package's generator in
distribution, not bit for bit.  :func:`surrogate_trace` draws the four
§5.3 surrogates from a seed that is stable across processes.

Ingestion (host numpy): :func:`load_trace_csv` reads ``timestamp,key,size``
CSVs and :func:`save_trace_bin` / :func:`load_trace_bin` the packed
``DHCT`` v1 binary format, both into a :class:`RawTrace` (f64 times,
64-bit keys: FNV-1a for strings, :func:`key_u64`).  :func:`compact_requests`
maps raw keys onto a dense universe (top-K hot keys get their own ids, the
cold tail shares a recycled pool) as a
:class:`repro_torch.core.trace.RequestStream`; :func:`realworld_raw`
generates the long epoch-time CDN-like trace.  Every column equals the
JAX package's bit for bit except the pre-drawn latencies, which
:func:`compact_requests` draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ..core.distributions import Exponential, MissLatency, make_distribution
from ..core.trace import RequestStream, Trace, make_trace

__all__ = ["SyntheticSpec", "zipf_probs", "synthetic_trace",
           "surrogate_trace", "SURROGATES",
           "RawTrace", "CompactionStats", "RealWorldSpec",
           "key_u64", "load_trace_csv", "save_trace_bin", "load_trace_bin",
           "compact_requests", "exact_requests", "realworld_raw"]


def zipf_probs(n: int, alpha: float, device=None) -> torch.Tensor:
    """Zipf(alpha) popularity over n ranked objects (f32)."""
    r = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    w = r ** (-alpha)
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_objects: int = 100
    n_requests: int = 100_000
    zipf_alpha: float = 0.9
    size_min: float = 1.0          # MB
    size_max: float = 100.0
    rate: float = 1000.0           # global request rate (req/s)
    arrival: str = "poisson"       # 'poisson' | 'pareto'
    pareto_shape: float = 1.5      # heavy-tailed inter-arrivals (mean exists)
    latency_base: float = 0.005    # L: 5 ms (paper §5.4)
    latency_per_mb: float = 2e-4   # c: size-proportional component
    stochastic: bool = True        # Exp-distributed realized fetch latency
    latency_dist: str | None = None  # a distributions registry name
    dist_kwargs: tuple = ()        # e.g. (('k', 3),) for Erlang(k=3)

    def make_dist(self) -> MissLatency | None:
        if self.latency_dist is None:
            return None
        return make_distribution(self.latency_dist, **dict(self.dist_kwargs))


def _interarrivals(g: torch.Generator, spec: SyntheticSpec) -> torch.Tensor:
    kw = dict(generator=g, device=g.device, dtype=torch.float64)
    mean_gap = 1.0 / spec.rate
    if spec.arrival == "poisson":
        return torch.empty(spec.n_requests, device=g.device,
                           dtype=torch.float64).exponential_(
            1.0, generator=g) * mean_gap
    if spec.arrival == "pareto":
        a = spec.pareto_shape
        x_m = mean_gap * (a - 1.0) / a    # mean a*x_m/(a-1) == mean_gap
        u = torch.rand(spec.n_requests, **kw) * (1.0 - 1e-7) + 1e-7
        return x_m * u ** (-1.0 / a)
    raise ValueError(f"unknown arrival process {spec.arrival!r}")


def synthetic_trace(generator: torch.Generator,
                    spec: SyntheticSpec = SyntheticSpec(),
                    device=None) -> Trace:
    """Draw a synthetic trace from ``generator`` (on its device), placed on
    ``device`` (None: the card)."""
    g = generator
    u = torch.rand(spec.n_objects, generator=g, device=g.device,
                   dtype=torch.float32)
    sizes = torch.floor(spec.size_min + u * (spec.size_max + 1.0
                                             - spec.size_min))
    probs = zipf_probs(spec.n_objects, spec.zipf_alpha, device=g.device)
    objs = torch.multinomial(probs, spec.n_requests, replacement=True,
                             generator=g)
    times = torch.cumsum(_interarrivals(g, spec), 0).to(torch.float32)
    z_mean = spec.latency_base + spec.latency_per_mb * sizes
    return make_trace(times, objs, sizes, z_mean, generator=g,
                      stochastic=spec.stochastic, dist=spec.make_dist(),
                      device=device)


# Surrogates for the four real traces (Fig. 3 calibration), at reduced
# universe sizes with the cache-to-footprint ratio kept comparable.
SURROGATES: dict[str, SyntheticSpec] = {
    # Wiki CDN: strong skew, small-object regime, near-Poisson arrivals.
    "wiki2018": SyntheticSpec(n_objects=2000, n_requests=200_000,
                              zipf_alpha=1.05, size_min=0.01, size_max=4.0,
                              rate=2000.0, arrival="poisson"),
    "wiki2019": SyntheticSpec(n_objects=2500, n_requests=200_000,
                              zipf_alpha=0.95, size_min=0.01, size_max=4.0,
                              rate=2500.0, arrival="poisson"),
    # Cloud block storage: flatter popularity, fixed-size blocks, bursty.
    "cloud": SyntheticSpec(n_objects=3000, n_requests=200_000,
                           zipf_alpha=0.65, size_min=0.5, size_max=2.0,
                           rate=4000.0, arrival="pareto", pareto_shape=1.3),
    # YouTube campus: moderate skew, large objects, bursty arrivals.
    "youtube": SyntheticSpec(n_objects=1500, n_requests=150_000,
                             zipf_alpha=0.8, size_min=5.0, size_max=200.0,
                             rate=600.0, arrival="pareto", pareto_shape=1.6),
}


def surrogate_seed(name: str) -> int:
    """The default seed of a surrogate: CRC-32 of its name, the same in
    every process (Python's ``hash`` of a str is salted per process)."""
    return zlib.crc32(name.encode())


def surrogate_trace(name: str, generator: torch.Generator | None = None,
                    device=None, **overrides) -> Trace:
    """The surrogate ``name`` with its spec's fields replaced by
    ``overrides``, drawn from ``generator`` (a CPU generator seeded
    :func:`surrogate_seed` when None) and placed on ``device`` (None: the
    card).  Overrides of the latency model keep the same requests."""
    spec = SURROGATES[name]
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    if generator is None:
        generator = torch.Generator().manual_seed(surrogate_seed(name))
    return synthetic_trace(generator, spec, device=device)


# ===========================================================================
# Real-world trace ingestion (host numpy)
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class RawTrace:
    """Per-request columns straight off a trace file.

    times  f64[T] absolute request timestamps (seconds)
    keys   u64[T] raw object keys (numeric ids verbatim, strings hashed,
                  :func:`key_u64`)
    sizes  f32[T] object size as reported per request
    """

    times: np.ndarray
    keys: np.ndarray
    sizes: np.ndarray

    @property
    def n_requests(self) -> int:
        return self.times.shape[0]

    def sorted(self) -> "RawTrace":
        """Time-ordered copy (stable: equal timestamps keep file order);
        self when already non-decreasing."""
        if self.times.shape[0] < 2 or bool(
                np.all(np.diff(self.times) >= 0.0)):
            return self
        order = np.argsort(self.times, kind="stable")
        return RawTrace(self.times[order], self.keys[order],
                        self.sizes[order])


_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_U64 = 0xFFFFFFFFFFFFFFFF


def key_u64(key: str) -> int:
    """Stable 64-bit key: decimal ids pass through verbatim, anything else
    is FNV-1a-hashed over its UTF-8 bytes.  ``isdecimal`` (not
    ``isdigit``) guards the int() path, which rejects digits such as
    superscripts."""
    key = key.strip()
    if key.isdecimal():
        return int(key) & _U64
    h = _FNV_OFFSET
    for b in key.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (wrapping u64 arithmetic)."""
    x = np.asarray(x, np.uint64).copy()
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def load_trace_csv(path, *, time_col: int = 0, key_col: int = 1,
                   size_col: int = 2, delimiter: str = ",") -> RawTrace:
    """Read a ``timestamp,key,size`` CSV into a RawTrace.

    Lines whose time or size field does not parse as a float (headers,
    comments, blanks) are skipped; rows are stable-sorted by time."""
    times, keys, sizes = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(delimiter)
            if len(parts) <= max(time_col, key_col, size_col):
                continue
            try:
                t = float(parts[time_col])
                s = float(parts[size_col])
            except ValueError:
                continue
            times.append(t)
            keys.append(key_u64(parts[key_col]))
            sizes.append(s)
    return RawTrace(np.asarray(times, np.float64),
                    np.asarray(keys, np.uint64),
                    np.asarray(sizes, np.float32)).sorted()


_BIN_MAGIC = b"DHCT"
_BIN_VERSION = 1
_BIN_DTYPE = np.dtype([("time", "<f8"), ("key", "<u8"), ("size", "<f4")])


def save_trace_bin(path, raw: RawTrace) -> None:
    """Write the packed format: a 16-byte header (magic, u32 version, u64
    record count), then little-endian ``(f64 time, u64 key, f32 size)``
    records."""
    rec = np.empty(raw.n_requests, _BIN_DTYPE)
    rec["time"] = raw.times
    rec["key"] = raw.keys
    rec["size"] = raw.sizes
    with open(path, "wb") as f:
        f.write(_BIN_MAGIC)
        f.write(np.uint32(_BIN_VERSION).tobytes())
        f.write(np.uint64(raw.n_requests).tobytes())
        rec.tofile(f)


def load_trace_bin(path) -> RawTrace:
    """Read the packed format written by :func:`save_trace_bin`."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _BIN_MAGIC:
            raise ValueError(f"{path}: not a packed trace "
                             f"(magic {magic!r} != {_BIN_MAGIC!r})")
        version = int(np.frombuffer(f.read(4), np.uint32)[0])
        if version != _BIN_VERSION:
            raise ValueError(f"{path}: unsupported trace version {version}")
        n = int(np.frombuffer(f.read(8), np.uint64)[0])
        rec = np.fromfile(f, _BIN_DTYPE, count=n)
    if rec.shape[0] != n:
        raise ValueError(f"{path}: truncated: header promises {n} records, "
                         f"file holds {rec.shape[0]}")
    return RawTrace(rec["time"].astype(np.float64),
                    rec["key"].astype(np.uint64),
                    rec["size"].astype(np.float32)).sorted()


@dataclasses.dataclass(frozen=True)
class CompactionStats:
    """What :func:`compact_requests` did to the key universe.  With
    ``n_unique <= top_k`` the mapping is injective and the replay exact;
    otherwise the cold tail (``tail_mass`` of the requests) shares
    ``n_recycle`` pooled ids."""

    n_unique: int           # distinct raw keys in the trace
    n_hot: int              # keys given dedicated dense ids (<= top_k)
    n_recycle: int          # size of the shared cold-tail id pool
    n_objects: int          # dense universe size the stream uses
    tail_unique: int        # distinct keys sharing the recycled pool
    tail_mass: float        # fraction of requests hitting the tail


def compact_requests(raw: RawTrace, *, top_k: int = 4096,
                     n_recycle: int = 512,
                     latency_base: float = 0.005,
                     latency_per_mb: float = 2e-4,
                     dist: MissLatency | None = None,
                     seed: int = 0,
                     generator: torch.Generator | None = None
                     ) -> tuple[RequestStream, CompactionStats]:
    """Map raw 64-bit keys onto a dense object universe and build a stream.

    The ``top_k`` most-requested keys get ids ``0..K-1`` (by descending
    count, ties by key value); colder keys hash (splitmix64) into a pool of
    ``n_recycle`` shared ids.  An object's size is its first-seen request
    size (1.0 for a pool id never hit); its mean fetch latency is
    ``L + c * size``.  The realized latencies are drawn from ``dist``
    (Exponential by default) with ``generator`` (a CPU generator seeded
    ``seed`` when None): that column matches the JAX package's in
    distribution, every other column bit for bit."""
    if top_k < 1 or n_recycle < 0:
        raise ValueError(f"top_k={top_k} must be >= 1, n_recycle="
                         f"{n_recycle} >= 0")
    raw = raw.sorted()
    uniq, inv, counts = np.unique(raw.keys, return_inverse=True,
                                  return_counts=True)
    inv = inv.reshape(-1)
    n_unique = uniq.shape[0]
    order = np.lexsort((uniq, -counts))
    rank = np.empty(n_unique, np.int64)
    rank[order] = np.arange(n_unique)
    n_hot = min(top_k, n_unique)
    hot = rank < top_k
    if n_unique <= top_k:
        ids_of_uniq = rank
        n_objects = n_unique
        tail_unique, tail_mass = 0, 0.0
    else:
        if n_recycle < 1:
            raise ValueError(
                f"trace has {n_unique} unique keys > top_k={top_k}; "
                f"n_recycle must be >= 1 to pool the tail")
        pool = top_k + (_mix64(uniq) % np.uint64(n_recycle)).astype(np.int64)
        ids_of_uniq = np.where(hot, rank, pool)
        n_objects = top_k + n_recycle
        tail_unique = int(n_unique - n_hot)
        tail_mass = float(counts[~hot].sum()) / float(raw.n_requests)
    objs = ids_of_uniq[inv].astype(np.int32)

    first = np.full(n_objects, raw.n_requests, np.int64)
    np.minimum.at(first, objs, np.arange(raw.n_requests))
    sizes_obj = np.ones(n_objects, np.float32)
    seen = first < raw.n_requests
    sizes_obj[seen] = raw.sizes[first[seen]]

    z_mean = (latency_base + latency_per_mb * sizes_obj).astype(np.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    unit = (dist or Exponential()).sample_unit(
        generator, (raw.n_requests,)).cpu().numpy().astype(np.float32)
    z_draw = z_mean[objs] * unit
    stream = RequestStream(times=raw.times.astype(np.float64), objs=objs,
                           sizes=sizes_obj, z_mean=z_mean, z_draw=z_draw)
    return stream, CompactionStats(
        n_unique=int(n_unique), n_hot=int(n_hot), n_recycle=int(n_recycle),
        n_objects=int(n_objects), tail_unique=tail_unique,
        tail_mass=tail_mass)


def exact_requests(raw: RawTrace, *, latency_base: float = 0.005,
                   latency_per_mb: float = 2e-4,
                   dist: MissLatency | None = None, seed: int = 0,
                   generator: torch.Generator | None = None
                   ) -> tuple[RequestStream, CompactionStats]:
    """:func:`compact_requests` on its injective branch: every distinct
    key its own id (``top_k`` = the distinct-key count)."""
    n_unique = int(np.unique(raw.keys).shape[0])
    return compact_requests(raw, top_k=n_unique, n_recycle=0,
                            latency_base=latency_base,
                            latency_per_mb=latency_per_mb, dist=dist,
                            seed=seed, generator=generator)


@dataclasses.dataclass(frozen=True)
class RealWorldSpec:
    """A CDN-like workload: Zipf popularity over a large key space, a
    sinusoidal diurnal rate cycle, lognormal object sizes and epoch-scale
    f64 timestamps (past the f32 clock's precision)."""

    n_requests: int = 1_000_000
    n_keys: int = 200_000
    zipf_alpha: float = 0.9
    rate: float = 2000.0            # mean request rate (req/s)
    diurnal_amplitude: float = 0.6  # peak-to-mean rate modulation in [0, 1)
    diurnal_period: float = 86400.0
    size_log_mu: float = 0.0        # lognormal object sizes (ln MB)
    size_log_sigma: float = 1.2
    size_max: float = 512.0
    start_time: float = 1.7e9       # epoch-like origin (seconds)
    seed: int = 0


def realworld_raw(spec: RealWorldSpec = RealWorldSpec()) -> RawTrace:
    """The long trace as raw per-request columns (numpy ``default_rng``):
    Zipf-ranked keys scrambled through splitmix64, exponential gaps
    thinned by the diurnal rate, times accumulated in f64."""
    if not 0.0 <= spec.diurnal_amplitude < 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1)")
    rng = np.random.default_rng(spec.seed)
    probs = np.arange(1, spec.n_keys + 1, dtype=np.float64) ** -spec.zipf_alpha
    probs /= probs.sum()
    ranks = rng.choice(spec.n_keys, size=spec.n_requests, p=probs)

    gaps = rng.exponential(1.0 / spec.rate, spec.n_requests)
    t_approx = np.cumsum(gaps)
    factor = 1.0 + spec.diurnal_amplitude * np.sin(
        2.0 * np.pi * t_approx / spec.diurnal_period)
    times = spec.start_time + np.cumsum(gaps / factor, dtype=np.float64)

    sizes_key = np.minimum(
        rng.lognormal(spec.size_log_mu, spec.size_log_sigma, spec.n_keys),
        spec.size_max).astype(np.float32)
    keys = _mix64(np.arange(spec.n_keys, dtype=np.uint64))
    return RawTrace(times, keys[ranks], sizes_key[ranks])
