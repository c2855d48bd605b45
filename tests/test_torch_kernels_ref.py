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


# --- lane_scatter_batch: a list of writes in one launch -----------------------
from repro_torch.kernels import lane_scatter as ls_mod  # noqa: E402

_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.bool: np.bool_}


def _batch_case(seed, n=29):
    """Seeded writes over three targets (f32 [6, n], i32 [3, n], bool
    [4, n]): set and add, with and without valid masks, some writes
    hitting an element an earlier write of the batch hit."""
    rng = np.random.default_rng(seed)
    xs = {torch.float32: (rng.standard_normal((6, n)) * 100)
          .astype(np.float32),
          torch.int32: rng.integers(-50, 50, (3, n)).astype(np.int32),
          torch.bool: rng.random((4, n)) < 0.5}
    writes, prev = [], {}
    for k in range(12):
        dt = list(xs)[k % 3]
        rows = xs[dt].shape[0]
        idx = rng.integers(0, n, rows).astype(np.int32)
        if dt in prev and k % 2:
            idx[: rows // 2 + 1] = prev[dt][: rows // 2 + 1]  # same elements
        prev[dt] = idx
        if dt == torch.bool:
            val = rng.random(rows) < 0.5
        elif dt == torch.int32:
            val = rng.integers(-50, 50, rows).astype(np.int32)
        else:
            val = (rng.standard_normal(rows) * 100).astype(np.float32)
        valid = rng.random(rows) < 0.7 if k % 3 == 1 else None
        writes.append((dt, idx, val, valid, bool(rng.random() < 0.5)))
    return xs, writes


def _bind(xs, writes):
    ts = {dt: torch.from_numpy(a.copy()) for dt, a in xs.items()}
    return ts, [(ts[dt], i, v, m, a) for dt, i, v, m, a in writes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_scatter_batch_ref_matches_pallas_in_order(seed):
    """The plain batch version equals the JAX lane_scatter_set / _add
    (interpret mode) applied write by write; a masked-off row is fed to
    JAX as a write of its own value (set) or of 0 (add)."""
    xs, writes = _batch_case(seed)
    ts, bound = _bind(xs, writes)
    ref.lane_scatter_batch_ref(bound)
    js = {dt: jnp.asarray(a) for dt, a in xs.items()}
    for dt, idx, val, valid, add in writes:
        x = js[dt]
        v = jnp.asarray(val)
        if valid is not None:
            keep = x[jnp.arange(x.shape[0]), idx] if not add \
                else jnp.zeros_like(v)
            v = jnp.where(jnp.asarray(valid), v, keep)
        fn = j_lane_add if add else j_lane_set
        js[dt] = fn(x, jnp.asarray(idx), v, interpret=True)
    for dt in xs:
        np.testing.assert_array_equal(ts[dt].numpy(), np.asarray(js[dt]))


def test_lane_scatter_batch_later_write_wins():
    x = torch.zeros(2, 5)
    ref.lane_scatter_batch_ref([
        (x, np.array([1, 2]), np.array([1.0, 2.0], np.float32), None,
         False),
        (x, np.array([1, 3]), np.array([5.0, 7.0], np.float32), None,
         False),
        (x, np.array([1, 3]), np.array([0.5, 0.5], np.float32),
         np.array([True, False]), True),
        (x, np.array([-1, 5]), np.array([9.0, 9.0], np.float32), None,
         False)])                                     # skipped: outside
    assert x.tolist() == [[0, 5.5, 0, 0, 0], [0, 0, 2.0, 7.0, 0]]


def test_lane_scatter_batch_cpu_wrapper_runs_ref_and_counts_calls():
    xs, writes = _batch_case(7)
    want, wb = _bind(xs, writes)
    ref.lane_scatter_batch_ref(wb)
    got, gb = _bind(xs, writes)
    before, calls = launch_counts(), dict(ls_mod.calls)
    ls_mod.lane_scatter_batch(gb)
    assert launch_counts() == before                  # nothing launched
    assert ls_mod.calls["lane_scatter_batch"] == \
        calls["lane_scatter_batch"] + 1
    for dt in xs:
        assert torch.equal(got[dt], want[dt])


def test_lane_scatter_batch_rejects_bad_writes():
    x = torch.zeros(3, 4)
    for bad in ([(x, np.zeros(2, np.int32), np.zeros(2), None, False)],
                [(x, np.zeros(3, np.int32), np.zeros(2), None, False)],
                [(x, np.zeros(3, np.float32), np.zeros(3), None, False)],
                [(x, np.zeros(3, np.int32), np.zeros(3),
                  np.zeros(3, np.int32), False)],
                [(torch.zeros(3, 4, dtype=torch.float64),
                  np.zeros(3, np.int32), np.zeros(3), None, False)]):
        with pytest.raises(ValueError):
            ls_mod.lane_scatter_batch(bad)


def _run_blocks(blocks, targets):
    """Apply packed parameter blocks as csrc/lane_scatter.cu reads them:
    one (target, row) at a time, that target's writes in order."""
    H, T, W = ls_mod.HEAD_WORDS, ls_mod.TARGET_WORDS, ls_mod.WRITE_WORDS
    for b in blocks:
        assert b.dtype == np.int32 and len(b) <= ls_mod.BLOCK_WORDS
        u = b.view(np.uint32)
        nt, total = int(b[0]), int(b[1])
        assert total == sum(int(b[H + t * T + 3]) for t in range(nt))
        spans = []
        for t in range(nt):
            rec = b[H + t * T:H + (t + 1) * T]
            ptr = int(u[H + t * T]) | int(u[H + t * T + 1]) << 32
            n, rows, _, dtype, w0, nw = (int(v) for v in rec[2:])
            x = next(x for x in targets if x.data_ptr() <= ptr
                     < x.data_ptr() + x.numel() * x.element_size())
            r0 = (ptr - x.data_ptr()) // (n * x.element_size())
            nb = rows * n * x.element_size()
            assert all(ptr + nb <= s or e <= ptr for s, e in spans)
            spans.append((ptr, ptr + nb))             # no aliasing
            for r in range(rows):
                for w in range(w0, w0 + nw):
                    add, off = (int(v) for v in
                                b[H + nt * T + w * W:H + nt * T + w * W + 2])
                    j, v = int(b[off + r]), b[off + rows + r]
                    if not 0 <= j < n:
                        continue
                    if dtype == 0:
                        v = torch.tensor(np.int32(v).view(np.float32))
                    elif dtype == 1:
                        v = torch.tensor(np.int32(v))
                    else:
                        v = torch.tensor(bool(v))
                    cur = x[r0 + r, j]
                    x[r0 + r, j] = (cur | v if dtype == 2 else cur + v) \
                        if add else v


@pytest.mark.parametrize("cap", [ls_mod.BLOCK_WORDS, 1020, 61])
def test_pack_applies_every_write_in_order(cap):
    """The parameter blocks, read as the kernel reads them, apply the batch
    exactly as the plain version does: across targets that are views of
    one another (rows of a [2L, N] state and its first L rows), with
    duplicate elements, masks and indices outside [0, N), and when the
    batch is cut into several blocks (a small ``cap`` cuts single writes
    by rows)."""
    rng = np.random.default_rng(3)
    n = 23
    f = torch.from_numpy(rng.standard_normal((24, n)).astype(np.float32))
    b = torch.from_numpy(rng.random((4, n)) < 0.5)
    cached = b[:2]                                    # a view of b
    writes = []
    for k in range(30):
        x = (f, b, cached)[k % 3]
        rows = x.shape[0]
        idx = rng.integers(-2, n + 2, rows)
        val = (rng.standard_normal(rows) * 10).astype(np.float32) \
            if x.dtype == torch.float32 else rng.random(rows) < 0.5
        valid = rng.random(rows) < 0.6 if k % 4 == 0 else None
        writes.append((x, idx, val, valid, bool(k % 5 == 2)))
    want_f, want_b = f.clone(), b.clone()
    ref.lane_scatter_batch_ref(
        [({id(f): want_f, id(b): want_b}.get(id(x), want_b[:2]), *w)
         for x, *w in writes])
    _, checked = ls_mod._prepare(writes)
    blocks = ls_mod.pack(checked, cap=cap)
    assert len(blocks) >= (2 if cap < ls_mod.BLOCK_WORDS else 1)
    _run_blocks(blocks, [f, b])
    assert torch.equal(f, want_f) and torch.equal(b, want_b)


def test_pack_serve_batch_is_one_small_block():
    """The simulator's serve write (12 f32 fields and 2 flags of 2 lanes)
    packs into one block that fits the kernel's 512-byte variant."""
    vals = torch.zeros(24, 100)
    flags = torch.zeros(4, 100, dtype=torch.bool)
    _, w = ls_mod._prepare([
        (vals, np.arange(24), np.ones(24, np.float32), None, False),
        (flags, np.arange(4), np.ones(4, bool), None, False)])
    blocks = ls_mod.pack(w)
    assert len(blocks) == 1 and len(blocks[0]) <= 128
