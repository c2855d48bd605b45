"""The port's gated-linear-attention path against the JAX package's, on the
CPU, in f32: the ``gla_chunk`` wrapper (its plain chunkwise version on CPU
tensors) against the Pallas kernel in interpret mode and the XLA route of
``chunked_gla``; the sequential oracles; padding and the carried state;
the mLSTM, Mamba and sLSTM mixers.  The CUDA kernel itself is held against
the plain version on the card by chip_smoke.py (phase 6).

Inputs come from numpy with a seed and go to both packages.  The chunkwise
forms agree to ``rtol=atol=1e-5`` (f32 sums in another order); the
sequential oracles are held to JAX's own bound for them
(``atol=2e-4, rtol=2e-3``, tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.gla_chunk import gla_chunk as j_gla_chunk
from repro.models import ssm as jssm
from repro_torch.kernels import launch_counts, ref
from repro_torch.kernels.gla_chunk import gla_chunk
from repro_torch.models import ssm

TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(atol=2e-4, rtol=2e-3)

# tests/test_kernels.py's gla_chunk shapes: (b, s, h, dk, dv, chunk)
SHAPES = [(1, 128, 2, 16, 32, 32), (2, 256, 2, 64, 64, 64),
          (1, 64, 4, 8, 16, 16)]


def _logsig(x):
    return (-np.logaddexp(0.0, -x)).astype(np.float32)


def _inputs(b, s, h, dk, dv, seed, f_shift=-1.0):
    rng = np.random.default_rng(seed)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return (n(b, s, h, dk), (n(b, s, h, dk) * 0.3).astype(np.float32),
            n(b, s, h, dv), _logsig(n(b, s, h) + f_shift),
            _logsig(n(b, s, h)))


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_gla_chunk_plain_matches_pallas(b, s, h, dk, dv, chunk, normalize):
    xs = _inputs(b, s, h, dk, dv, seed=4)
    before = launch_counts()["gla_chunk"]
    y, (S, n) = gla_chunk(*_t(xs), chunk=chunk, normalize=normalize)
    assert launch_counts()["gla_chunk"] == before      # CPU: plain version
    jy, (jS, jn) = j_gla_chunk(*_j(xs), chunk=chunk, normalize=normalize)
    for got, want in ((y, jy), (S, jS), (n, jn)):
        _close(got, want)
    # and the chunkwise XLA route of the JAX model code
    xy, (xS, xn) = jssm.chunked_gla(*_j(xs), chunk=chunk,
                                    normalize=normalize)
    for got, want in ((y, xy), (S, xS), (n, xn)):
        _close(got, want)


def test_gla_chunk_matches_model_chunked_gla():
    """tests/test_kernels.py's kernel == XLA case, through the port's
    ``chunked_gla`` on both routes."""
    xs = _inputs(2, 128, 2, 32, 32, seed=5, f_shift=0.0)
    want_y, (want_s, want_n) = jssm.chunked_gla(*_j(xs), chunk=32)
    for route in (True, "ref"):
        y, (S, n) = ssm.chunked_gla(*_t(xs), chunk=32, use_kernel=route)
        _close(y, want_y)
        _close(S, want_s)
        _close(n, want_n)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_gla_chunk_ref_matches_jax_oracle(b, s, h, dk, dv, chunk, normalize):
    xs = _inputs(b, s, h, dk, dv, seed=6)
    y, (S, n) = ref.gla_chunk_ref(*_t(xs), normalize=normalize)
    jy, (jS, jn) = jref.gla_chunk_ref(*_j(xs), normalize=normalize)
    for got, want in ((y, jy), (S, jS), (n, jn)):
        _close(got, want, ORACLE_TOL)
    # the chunkwise plain version against the sequential oracle
    py, (pS, pn) = ref.gla_chunk_plain(*_t(xs), chunk=chunk,
                                       normalize=normalize)
    for got, want in ((py, y), (pS, S), (pn, n)):
        _close(got, want.numpy(), ORACLE_TOL)


@pytest.mark.parametrize("s,chunk", [(50, 16), (100, 32), (7, 16)])
@pytest.mark.parametrize("route", [True, "ref"])
def test_chunked_gla_pads_like_jax(s, chunk, route):
    """S not a multiple of the chunk: padded with f = 1, log i = -30."""
    xs = _inputs(1, s, 2, 16, 24, seed=s)
    y, (S, n) = ssm.chunked_gla(*_t(xs), chunk=chunk, use_kernel=route)
    jy, (jS, jn) = jssm.chunked_gla(*_j(xs), chunk=chunk)
    assert tuple(y.shape) == (1, s, 2, 24)
    for got, want in ((y, jy), (S, jS), (n, jn)):
        _close(got, want)
    ky, (kS, kn) = jssm.chunked_gla(*_j(xs), chunk=chunk, use_kernel=True)
    for got, want in ((y, ky), (S, kS), (n, kn)):
        _close(got, want)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("route", [True, "ref"])
@pytest.mark.parametrize("normalize", [True, False])
def test_split_with_init_state_matches_jax(seed, route, normalize):
    """tests/test_properties.py's split-vs-full case: [0:32] then [32:64]
    with the carried state, against the JAX XLA route (its kernel route
    drops ``init_state``), and equal to the full run."""
    xs = _inputs(1, 64, 2, 8, 8, seed=100 + seed, f_shift=0.0)
    half = lambda a, sl: [x[:, sl] for x in a]
    kw = dict(chunk=16, normalize=normalize)
    y1, st1 = ssm.chunked_gla(*_t(half(xs, slice(0, 32))), use_kernel=route,
                              **kw)
    y2, st2 = ssm.chunked_gla(*_t(half(xs, slice(32, 64))), init_state=st1,
                              use_kernel=route, **kw)
    jy1, jst1 = jssm.chunked_gla(*_j(half(xs, slice(0, 32))), **kw)
    jy2, jst2 = jssm.chunked_gla(*_j(half(xs, slice(32, 64))),
                                 init_state=jst1, **kw)
    _close(y2, jy2)
    _close(st2[0], jst2[0])
    _close(st2[1], jst2[1])
    yf, stf = ssm.chunked_gla(*_t(xs), use_kernel=route, **kw)
    torch.testing.assert_close(yf[:, 32:], y2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(stf[0], st2[0], rtol=1e-4, atol=1e-4)


def test_chunked_gla_rejects_unknown_route():
    xs = _t(_inputs(1, 16, 1, 8, 8, seed=0))
    with pytest.raises(ValueError, match="use_kernel"):
        ssm.chunked_gla(*xs, chunk=16, use_kernel=False)
    with pytest.raises(ValueError, match="use_kernel"):
        ssm.chunked_gla(*xs, chunk=16, use_kernel="interpret")


def test_gla_chunk_wrapper_checks_arguments():
    q, k, v, lf, li = _t(_inputs(1, 48, 2, 8, 16, seed=1))
    with pytest.raises(ValueError, match="multiple of chunk"):
        gla_chunk(q, k, v, lf, li, chunk=32)
    with pytest.raises(ValueError, match="gates"):
        gla_chunk(q, k, v, lf[:, :, :1], li, chunk=16)
    with pytest.raises(ValueError, match="dtype"):
        gla_chunk(q, k.double(), v, lf, li, chunk=16)
    with pytest.raises(ValueError, match="init_state"):
        gla_chunk(q, k, v, lf, li, chunk=16,
                  init_state=(torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8)))


@pytest.mark.parametrize("normalize", [True, False])
def test_gla_decode_step_matches_jax(normalize):
    rng = np.random.default_rng(7)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    xs = [n(2, 3, 16), n(2, 3, 16) * 0.3, n(2, 3, 32), _logsig(n(2, 3)),
          _logsig(n(2, 3))]
    st = [n(2, 3, 16, 32) * 0.1, np.abs(n(2, 3, 16))]
    y, (S, nn) = ssm.gla_decode_step(*_t(xs), tuple(_t(st)),
                                     normalize=normalize)
    jy, (jS, jn) = jssm.gla_decode_step(*_j(xs), tuple(_j(st)),
                                        normalize=normalize)
    for got, want in ((y, jy), (S, jS), (nn, jn)):
        _close(got, want)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(with_tail):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_tail else None
    y, t = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           None if tail is None else torch.from_numpy(tail))
    jy, jt = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if tail is None else jnp.asarray(tail))
    _close(y, jy)
    _close(t, jt)


def _params(rng, shapes):
    return {k: (rng.standard_normal(s) * (s[0] ** -0.5 if len(s) > 1
                                          else 1.0)).astype(np.float32)
            for k, s in shapes.items()}


def _run_both(fn, jfn, p, x, **kw):
    out, st = fn({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), **kw)
    jout, jst = jfn({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), **kw)
    return out, st, jout, jst


def _mlstm_params(rng, d, di, h):
    p = _params(rng, {"w_up": (d, 2 * di), "conv": (4, di), "wq": (di, di),
                      "wk": (di, di), "wv": (di, di),
                      "w_gates": (di, 2 * h), "w_down": (di, d)})
    p["conv"] *= 0.1
    p["skip"] = np.ones(di, np.float32)
    return p


def _mamba_params(rng, d, di, h, n):
    p = _params(rng, {"w_in": (d, 2 * di), "conv": (4, di),
                      "w_bc": (di, 2 * n * h), "w_dt": (di, h),
                      "w_out": (di, d)})
    p["conv"] *= 0.1
    p["a_log"] = rng.standard_normal(h).astype(np.float32) * 0.5
    p["d_skip"] = rng.standard_normal(h).astype(np.float32)
    return p


@pytest.mark.parametrize("kind", ["mlstm", "mamba"])
@pytest.mark.parametrize("s", [20, 40])
def test_mixers_prefill_then_decode_match_jax(kind, s):
    """A prompt through the chunked path (S not a chunk multiple), then two
    decode steps carrying (state, conv tail), against JAX, whose chunked
    path takes its kernel route (Pallas in interpret mode)."""
    rng = np.random.default_rng(9 + s)
    d, di, h = 16, 32, 2
    if kind == "mlstm":
        p = _mlstm_params(rng, d, di, h)
        fn, jfn, kw = ssm.mlstm_apply, jssm.mlstm_apply, dict(n_heads=h)
    else:
        p = _mamba_params(rng, d, di, h, 8)
        fn, jfn = ssm.mamba_apply, jssm.mamba_apply
        kw = dict(n_heads=h, d_state=8)
    x = (rng.standard_normal((2, s + 2, d)) * 0.5).astype(np.float32)
    out, st, jout, jst = _run_both(fn, jfn, p, x[:, :s], chunk=16,
                                   use_kernel=True, **kw)
    _close(out, jout)
    (S, n), tail = st
    (jS, jn), jtail = jst
    for got, want in ((S, jS), (n, jn), (tail, jtail)):
        _close(got, want)
    state, jstate = ((S, n), tail), ((jS, jn), jtail)
    for t in (s, s + 1):
        out, state = fn({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x[:, t:t + 1]), state=state[0],
                        conv_tail=state[1], **kw)
        jout, jstate = jfn({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x[:, t:t + 1]), state=jstate[0],
                           conv_tail=jstate[1], **kw)
        _close(out, jout)
    # decode continues the prompt: equal to the full sequence's last rows
    full, _ = fn({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), chunk=16, **kw)
    torch.testing.assert_close(out[:, 0], full[:, s + 1], rtol=1e-4,
                               atol=1e-4)


def test_slstm_matches_jax_and_state_continuity():
    """sLSTM against JAX, and split-sequence state continuity (as in
    tests/test_kernels.py)."""
    rng = np.random.default_rng(10)
    b, s, d, h = 2, 24, 32, 4
    dh = d // h
    p = _params(rng, {"w_x": (d, 4 * d), "w_out": (d, d)})
    p["w_h"] = (rng.standard_normal((h, dh, 4 * dh))
                * dh ** -0.5).astype(np.float32)
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    out, st, jout, jst = _run_both(ssm.slstm_apply, jssm.slstm_apply, p, x,
                                   n_heads=h)
    assert tuple(out.shape) == (b, s, d) and bool(torch.isfinite(out).all())
    _close(out, jout)
    for got, want in zip(st, jst):
        _close(got, want)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, st1 = ssm.slstm_apply(tp, torch.from_numpy(x[:, :12]), n_heads=h)
    y2, st2 = ssm.slstm_apply(tp, torch.from_numpy(x[:, 12:]), n_heads=h,
                              state=st1)
    torch.testing.assert_close(y2, out[:, 12:], rtol=1e-3, atol=1e-4)
    for a, bb in zip(st, st2):
        torch.testing.assert_close(a, bb, rtol=1e-3, atol=1e-4)


def test_init_leaf_dtypes_match_jax():
    """Inits keep the JAX package's dtypes in a bf16 model: the gate and
    step-size projections, decay and skip stay f32."""
    import jax
    g = torch.Generator().manual_seed(0)
    pairs = [(ssm.init_mlstm(g, 16, 2), jssm.init_mlstm(jax.random.key(0),
                                                         16, 2)),
             (ssm.init_mamba(g, 16, 32, 2, 8),
              jssm.init_mamba(jax.random.key(0), 16, 32, 2, 8)),
             (ssm.init_slstm(g, 16, 2), jssm.init_slstm(jax.random.key(0),
                                                         16, 2))]
    for mine, theirs in pairs:
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert tuple(mine[k].shape) == theirs[k].shape, k
            want = torch.float32 if theirs[k].dtype == jnp.float32 \
                else torch.bfloat16
            assert mine[k].dtype == want, k
            assert (k in ssm.F32_LEAVES) == (want == torch.float32), k


def test_row_alignment_check():
    """The CUDA kernels load rows 16 bytes at a time: a misaligned view or
    a strided last axis is refused before any launch."""
    from repro_torch.kernels.flash_attention import check_rows_16b
    t = torch.zeros(1, 4, 2, 16)
    check_rows_16b("q", t)
    check_rows_16b("q", torch.chunk(t, 2, dim=-1)[1])   # offset 32 bytes
    with pytest.raises(ValueError, match="16-byte"):
        check_rows_16b("q", t[..., 1:9])
    with pytest.raises(ValueError, match="contiguous"):
        check_rows_16b("q", t.transpose(2, 3))
