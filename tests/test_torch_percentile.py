"""The port's streaming quantile sketch against the JAX package's, bit for
bit: exact mode, bucket mode, merges and the clamping edges."""
import math

import numpy as np
import pytest

from repro.core import percentile as jp
from repro_torch.core import percentile as tp


def _state(sq):
    return (sq.counts.tobytes(), sq.zero_count, sq.count, sq.sum, sq.min,
            sq.max, list(sq._buf), sq.n_buckets, sq.gamma)


def _both(**kw):
    return jp.StreamingQuantile(**kw), tp.StreamingQuantile(**kw)


QS = (0.0, 0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999, 1.0)


def _same(a, b):
    assert _state(a) == _state(b)
    assert [a.quantile(q) for q in QS] == [b.quantile(q) for q in QS]
    assert a.summary().as_dict(scale=1e3) == b.summary().as_dict(scale=1e3)
    assert a.summary() == jp.QuantileSummary(**vars(b.summary()))


@pytest.mark.parametrize("n", [1, 2, 7, 300, 512])
def test_exact_mode_equals_reference(n):
    x = np.random.default_rng(n).lognormal(-3.0, 1.5, n)
    a, b = _both()
    a.add(x)
    b.add(x)
    assert b._buf                       # still exact
    _same(a, b)
    assert b.quantile(0.5) == float(np.percentile(x, 50.0))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bucket_mode_equals_reference(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.pareto(1.5, 5000) * 0.01, np.zeros(40),
                        rng.exponential(0.1, 3000)])
    rng.shuffle(x)
    a, b = _both(rel_err=0.005, min_value=1e-6, max_value=1e5)
    for chunk in np.array_split(x, 13):
        a.add(chunk)
        b.add(chunk)
    assert not b._buf                   # spilled into the buckets
    _same(a, b)


@pytest.mark.parametrize("sizes", [(100, 200, 150), (600, 3, 1000),
                                   (512, 1, 0, 40)])
def test_merge_equals_reference_and_monolithic(sizes):
    rng = np.random.default_rng(sum(sizes))
    parts = [rng.exponential(0.05, s) for s in sizes]
    ja, ta = [], []
    for p in parts:
        a, b = _both(exact_n=512)
        a.add(p)
        b.add(p)
        ja.append(a)
        ta.append(b)
    for a, b in zip(ja[1:], ta[1:]):
        ja[0].merge(a)
        ta[0].merge(b)
    _same(ja[0], ta[0])
    mono = tp.StreamingQuantile(exact_n=512).add(np.concatenate(parts))
    pick = lambda s: s[:3] + s[4:7]     # every field but the f64 sum
    assert pick(_state(mono)) == pick(_state(ta[0]))


def test_clamping_edges_equal_reference():
    a, b = _both(min_value=1e-3, max_value=1e3, exact_n=2)
    for v in ([1e-6, 1e6, 5.0], [0.0, -1.0, 1e-3, 1e3], 2e9, [7.5e-4]):
        a.add(v)
        b.add(v)
    _same(a, b)
    assert b.zero_count == 2
    top = int(b._bucket_of(np.array([b.max_value]))[0])
    assert b.counts[0] == 3 and b.counts[top] == 3   # clamped both ends
    assert b.quantile(0.0) >= -1.0 and b.quantile(1.0) <= 2e9


def test_empty_edges_and_errors_match_reference():
    for mod in (jp, tp):
        sq = mod.StreamingQuantile()
        assert math.isnan(sq.quantile(0.5)) and math.isnan(sq.mean)
        s = sq.summary()
        assert s.count == 0 and math.isnan(s.max)
        sq.add([])
        assert sq.count == 0
        sq.add(2.5)
        assert sq.quantile(0.0) == sq.quantile(1.0) == 2.5
        with pytest.raises(ValueError):
            sq.quantile(1.5)
        with pytest.raises(ValueError):
            sq.quantile(-0.1)
        with pytest.raises(ValueError, match="geometry"):
            mod.StreamingQuantile(rel_err=0.01).merge(
                mod.StreamingQuantile(rel_err=0.02))
        with pytest.raises(ValueError):
            mod.StreamingQuantile(rel_err=1.0)
        with pytest.raises(ValueError):
            mod.StreamingQuantile(min_value=2.0, max_value=1.0)
