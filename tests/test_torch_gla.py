"""The rounding of the ``gla_chunk`` kernel's tensor-core (bf16) route,
emulated on the CPU by ``ref.gla_chunk_split`` (chunk-local states, a scan
over chunks, f32 operands split into bf16 hi + lo against bf16 q, k and
v), held against the JAX package: its Pallas kernel in interpret mode and
its sequential oracle, and, where an initial state is given, the XLA
route of ``chunked_gla`` (the JAX kernel route drops ``init_state``).  The
CUDA kernel itself is held against the plain version and this emulation
on the card by chip_smoke.py (phase 6).

Inputs come from numpy with a seed, rounded to bf16 once, and go to both
packages.  The bound is chip_smoke.py phase 6's: ``|got - want| <= 1e-4 +
1e-3 |want|``, plus one bf16 ulp on y (the two round y to bf16 from f32
values that differ in their last bits).  With the splitting turned off and
f32 inputs, the decomposition equals ``gla_chunk_plain`` to ``rtol = atol
= 1e-5`` (f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.gla_chunk import gla_chunk as j_gla_chunk
from repro.models import ssm as jssm
from repro_torch.kernels import ref

# (b, s, h, dk, dv, chunk): dk 16/64, dv 32/128, chunks 16/64, 1-3 chunks
SHAPES = [(1, 16, 2, 16, 32, 16), (2, 48, 2, 16, 128, 16),
          (1, 64, 3, 64, 32, 64), (2, 192, 2, 64, 128, 64),
          (1, 128, 2, 16, 128, 64)]


def _logsig(x):
    return (-np.logaddexp(0.0, -x)).astype(np.float32)


def _inputs(b, s, h, dk, dv, seed):
    """q, k, v rounded to bf16 (returned as f32 numpy arrays holding bf16
    values) and f32 log-sigmoid gates."""
    rng = np.random.default_rng(seed)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    bf = lambda x: torch.from_numpy(x).bfloat16().float().numpy()
    return (bf(n(b, s, h, dk)), bf(n(b, s, h, dk) * 0.3), bf(n(b, s, h, dv)),
            _logsig(n(b, s, h) - 1.0), _logsig(n(b, s, h)))


def _state(b, h, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, h, dk, dv)) * 0.1).astype(np.float32),
            np.abs(rng.standard_normal((b, h, dk))).astype(np.float32))


def _t(xs, bf16=True):
    """numpy -> torch; q, k, v (the first three) as bf16 when ``bf16``."""
    out = [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
    return [x.bfloat16() if bf16 and i < 3 else x for i, x in enumerate(out)]


def _j(xs):
    return [jnp.asarray(x).astype(jnp.bfloat16) if i < 3 else jnp.asarray(x)
            for i, x in enumerate(xs)]


def _within(got, want, bf16: bool) -> float:
    """Largest ``|got - want| / (1e-4 + 1e-3 |want| [+ 1 bf16 ulp])``, as
    chip_smoke.within; <= 1 passes."""
    g = torch.as_tensor(np.asarray(got, np.float32)) \
        if not isinstance(got, torch.Tensor) else got.float()
    w = torch.as_tensor(np.array(want, np.float32))
    lim = 1e-4 + 1e-3 * w.abs()
    if bf16:
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        _, e = torch.frexp(mag)
        lim = lim + torch.ldexp(torch.ones_like(mag), e - 8)
    return float(((g - w).abs() / lim).max())


def _assert_within(res, want):
    y, (S, n) = res
    wy, (wS, wn) = want
    assert y.dtype == torch.bfloat16
    r = max(_within(y, wy, True), _within(S, wS, False),
            _within(n, wn, False))
    assert r <= 1.0, r


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_split_emulation_matches_pallas_and_oracle(b, s, h, dk, dv, chunk,
                                                   normalize):
    xs = _inputs(b, s, h, dk, dv, seed=16 + s + dk)
    got = ref.gla_chunk_split(*_t(xs), chunk=chunk, normalize=normalize)
    _assert_within(got, j_gla_chunk(*_j(xs), chunk=chunk,
                                    normalize=normalize, interpret=True))
    _assert_within(got, jref.gla_chunk_ref(*_j(xs), normalize=normalize))


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_split_emulation_with_init_state_matches_xla(b, s, h, dk, dv, chunk,
                                                     normalize):
    xs = _inputs(b, s, h, dk, dv, seed=32 + s + dv)
    st = _state(b, h, dk, dv, seed=s)
    got = ref.gla_chunk_split(*_t(xs), chunk=chunk, normalize=normalize,
                              init_state=tuple(_t(st, bf16=False)))
    want = jssm.chunked_gla(*_j(xs), chunk=chunk, normalize=normalize,
                            init_state=tuple(jnp.asarray(x) for x in st))
    _assert_within(got, want)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("init", [False, True])
def test_decomposition_without_split_equals_plain(b, s, h, dk, dv, chunk,
                                                  normalize, init):
    """Local states + scan + outputs in f32 == the chunkwise plain version."""
    rng = np.random.default_rng(s + dk + dv)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    xs = _t((n(b, s, h, dk), n(b, s, h, dk) * 0.3, n(b, s, h, dv),
             _logsig(n(b, s, h) - 1.0), _logsig(n(b, s, h))), bf16=False)
    st = tuple(_t(_state(b, h, dk, dv, seed=7), bf16=False)) if init \
        else None
    kw = dict(chunk=chunk, normalize=normalize, init_state=st)
    y, (S, nn) = ref.gla_chunk_split(*xs, split=False, **kw)
    py, (pS, pn) = ref.gla_chunk_plain(*xs, **kw)
    for got, want in ((y, py), (S, pS), (nn, pn)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_split_rounds_like_the_kernel(monkeypatch):
    """The split is not a no-op on bf16 inputs: the emulation differs from
    the unsplit f32 decomposition only by the hi + lo rounding (far inside
    the bound), and a single bf16 term would leave the bound."""
    xs = _t(_inputs(1, 128, 2, 64, 128, seed=3))
    y, (S, n) = ref.gla_chunk_split(*xs, chunk=64)
    fy, (fS, fn) = ref.gla_chunk_split(*xs, chunk=64, split=False)
    assert not torch.equal(S, fS)
    assert _within(S, fS.numpy(), False) < 0.05
    assert _within(y, fy.float().numpy(), True) <= 1.0
    monkeypatch.setattr(ref, "_bf16_terms", lambda p: (
        p.bfloat16().float(), torch.zeros_like(p)))
    _, (hS, _) = ref.gla_chunk_split(*xs, chunk=64)
    assert _within(hS, fS.numpy(), False) > 1.0


def test_tile_constants_match_the_source():
    """The wrapper's tiles (block counts in chip_smoke.py) are the CUDA
    source's, and a kernel that is no template is still found in a
    profile."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import gla_chunk as wrapper
    from repro_torch.profile_serve import is_port_kernel
    src = (_build.CSRC / "gla_chunk.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert wrapper.STATE_TILE == (const["kSD"], const["kSV"])
    assert wrapper.OUT_TILE[1] == const["kOV"]
    assert wrapper.SCORE_TILE == const["kAT"]
    assert wrapper.OUT_SMALL_DK == const["kORDK"]
    assert wrapper.SCAN_THREADS == const["kScanThreads"]
    assert wrapper.tc_blocks(1, 2048, 4, 512, 512, 256) == {
        "gla_state_kernel": 8 * 4 * 8 * 8, "gla_scan_kernel": 1026,
        "gla_score_kernel": 8 * 4 * 10, "gla_out_kernel": 8 * 2 * 4 * 4}
    assert wrapper.tc_blocks(1, 2304, 25, 16, 128, 256) == {
        "gla_state_kernel": 9 * 25 * 2, "gla_scan_kernel": 51,
        "gla_score_kernel": 9 * 25 * 10, "gla_out_kernel": 9 * 4 * 25}
    assert is_port_kernel("void (anonymous namespace)::gla_out_kernel("
                          "__nv_bfloat16 const*)")
    assert not is_port_kernel("void (anonymous namespace)::gla_out_kernel2("
                              "int)")
