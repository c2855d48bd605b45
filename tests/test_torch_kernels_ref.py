"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode: eq.-16 scores
and victim selection (rows 1-2 of the kernel table) and the lane scatter
(row 3).  The CUDA kernels themselves are held against these plain versions
on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.lane_scatter import lane_scatter_add as j_lane_add
from repro.kernels.lane_scatter import lane_scatter_set as j_lane_set
from repro.kernels.ranking_score import ranking_scores as j_scores
from repro.kernels.ranking_score import ranking_victim_order as j_order
from repro_torch.kernels import (lane_scatter_add, lane_scatter_set,
                                 launch_counts, ranking_scores,
                                 ranking_victim_order, ref)

# Eager torch and interpreted Pallas may round one f32 op differently.
RTOL = 1e-6


def _inputs(n, seed, density=0.5):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    return (u(1e-3, 50.0), u(1e-3, 2.0), u(1e-3, 10.0), u(1.0, 100.0),
            rng.random(n) < density)


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("omega", [0.0, 1.0, 2.5])
def test_ranking_scores_matches_pallas(n, omega):
    args = _inputs(n, seed=6)
    f, idx, val = ranking_scores(*_torch(args), omega=omega)
    jf, jidx, jval = j_scores(*(jnp.asarray(a) for a in args), omega=omega,
                              block=256, interpret=True)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=RTOL)
    assert int(idx) == int(jidx)
    np.testing.assert_allclose(float(val), float(jval), rtol=RTOL)
    assert idx.dtype == torch.int32


@pytest.mark.parametrize("n,top", [(100, 4), (1000, 8), (700, 16)])
def test_ranking_victim_order_matches_pallas(n, top):
    args = _inputs(n, seed=9)
    f, idx, vals = ranking_victim_order(*_torch(args), omega=1.0, top=top)
    jf, jidx, jvals = j_order(*(jnp.asarray(a) for a in args), omega=1.0,
                              top=top, block=256, interpret=True)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=RTOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=RTOL)


def test_sparse_cache_emits_inf_sentinels():
    """Fewer cached objects than ``top``: the order continues with +inf,
    never with a resurrected finite score; the sentinels' indices are the
    lowest uncached objects, in order."""
    n = 256
    args = (np.full(n, 1.0, np.float32), np.full(n, 0.1, np.float32),
            np.full(n, 1.0, np.float32), np.full(n, 2.0, np.float32),
            np.isin(np.arange(n), [0, 9]))
    f, idx, vals = ranking_victim_order(*_torch(args), omega=1.0, top=8)
    jf, jidx, jvals = j_order(*(jnp.asarray(a) for a in args), omega=1.0,
                              top=8, block=128, interpret=True)
    v = vals.numpy()
    assert np.isfinite(v[:2]).all() and np.isinf(v[2:]).all()
    assert idx[:2].tolist() == [0, 9]
    assert idx[2:].tolist() == [1, 2, 3, 4, 5, 6]
    np.testing.assert_array_equal(np.isinf(v), np.isinf(np.asarray(jvals)))
    np.testing.assert_allclose(v[:2], np.asarray(jvals)[:2], rtol=RTOL)
    assert set(np.asarray(jidx)[:2]) == {0, 9}


def test_ties_go_to_the_lower_index():
    """Duplicated inputs tie exactly: the order is ascending (score, index),
    as JAX's top_k/argmin convention on the same scores."""
    lam, z, r, s, cached = _inputs(600, seed=3, density=0.7)
    src = np.arange(0, 600, 7)
    # 86 identical scores, below every other one
    for a, v in ((lam, 1e-3), (z, 1e-3), (r, 10.0), (s, 100.0)):
        a[src] = v
    args = _torch((lam, z, r, s, cached))
    f, idx, vals = ranking_victim_order(*args, omega=1.0, top=16)
    jidx, jvals = jref.victim_order_ref(jnp.asarray(f.numpy()),
                                        jnp.asarray(cached), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    tied = src[cached[src]]
    assert idx[:16].tolist() == tied[:16].tolist()
    f2, i2, v2 = ranking_scores(*args, omega=1.0)
    assert int(i2) == int(tied[0])


def test_victim_order_ref_is_argmin_remove_sequence():
    scores = torch.tensor([3.0, 1.0, 2.0, 1.0, 5.0, 1.0])
    cached = torch.tensor([True, True, False, True, True, True])
    idx, vals = ref.victim_order_ref(scores, cached, 6)
    assert idx.tolist() == [1, 3, 5, 0, 4, 2]
    assert vals.tolist() == [1.0, 1.0, 1.0, 3.0, 5.0, float("inf")]


def test_scores_at_sentinel_count_as_inf():
    """A score at or above 3.4e38 is +inf in the selection, by value."""
    args = list(_torch(_inputs(64, seed=1, density=1.0)))
    args[2][5] = 1e-6                          # resid and size tiny
    args[3][5] = 1e-6
    args[0][5], args[1][5] = 1e30, 1e10        # score overflows to inf
    f, idx, vals = ranking_victim_order(*args, omega=1.0, top=64)
    assert f[5] >= ref.SENTINEL
    assert int(idx[-1]) == 5 and vals[-1] == float("inf")


def test_top_above_block_raises():
    args = _torch(_inputs(5000, seed=2))
    with pytest.raises(ValueError, match="top"):
        ranking_victim_order(*args, top=2000)


def test_cpu_wrappers_launch_nothing():
    before = launch_counts()
    args = _torch(_inputs(100, seed=0))
    ranking_victim_order(*args)
    ranking_scores(*args)
    lane_scatter_set(torch.zeros(2, 5), torch.tensor([1, 2]),
                     torch.ones(2))
    assert launch_counts() == before


def _lane_case(lanes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = 37
    if dtype == np.bool_:
        x = rng.standard_normal((lanes, n)) > 0
        val = rng.standard_normal(lanes) > 0
    else:
        x = (rng.standard_normal((lanes, n)) * 100).astype(dtype)
        val = (rng.standard_normal(lanes) * 100).astype(dtype)
    idx = rng.integers(0, n, lanes).astype(np.int32)
    if lanes > 1:
        idx[1] = idx[0]            # two lanes, one column: no interference
    return x, idx, val


@pytest.mark.parametrize("lanes", [1, 7, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_],
                         ids=["f32", "i32", "bool"])
@pytest.mark.parametrize("add", [False, True])
def test_lane_scatter_matches_pallas(lanes, dtype, add):
    x, idx, val = _lane_case(lanes, dtype)
    fn, jfn = (lane_scatter_add, j_lane_add) if add \
        else (lane_scatter_set, j_lane_set)
    xt = torch.from_numpy(x.copy())
    got = fn(xt, torch.from_numpy(idx), torch.from_numpy(np.asarray(val)))
    assert got is xt                                  # updated in place
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(idx),
                          jnp.asarray(val), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.bool_], ids=["f32", "bool"])
@pytest.mark.parametrize("add", [False, True])
def test_lane_scatter_invalid_lanes_keep_their_bits(dtype, add):
    x, idx, val = _lane_case(8, dtype, seed=5)
    valid = np.array([True, False] * 4)
    fn = lane_scatter_add if add else lane_scatter_set
    got = fn(torch.from_numpy(x.copy()), torch.from_numpy(idx),
             torch.from_numpy(np.asarray(val)),
             torch.from_numpy(valid)).numpy()
    full = fn(torch.from_numpy(x.copy()), torch.from_numpy(idx),
              torch.from_numpy(np.asarray(val))).numpy()
    np.testing.assert_array_equal(got[valid], full[valid])
    np.testing.assert_array_equal(got[~valid], x[~valid])


def test_lane_scatter_rejects_bad_shapes():
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError):
        lane_scatter_set(x, torch.tensor([0, 1]), torch.ones(2))
    with pytest.raises(ValueError):
        lane_scatter_set(torch.zeros(3, 4, dtype=torch.float64),
                         torch.tensor([0, 1, 2]), torch.ones(3))
