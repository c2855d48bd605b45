"""The port's attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``use_kernel=True``,
as tests/test_kernels.py does); the port's wrappers run their plain
versions for CPU tensors.  Inputs come from a numpy seed and reach both
packages as the same numbers (bf16 inputs are rounded from the same f32
draws).  Tolerances: f32 ``rtol=1e-5, atol=1e-6`` (the two differ only in
the order of f32 sums: one softmax over the whole key axis against an
online softmax over key blocks); bf16 ``atol=2e-2`` (one bf16 rounding of
outputs below 4 in magnitude, as tests/test_kernels.py allows).

The emulations of the two CUDA designs (``ref.flash_attention_split_p``:
tensor-core products with P split into bf16 hi + lo; ``ref.
decode_attention_splits``: per-split partial softmax states and their
merge) are held to the bounds that chip_smoke.py phase 4 holds the
kernels to: f32 max |diff| <= 1e-5, bf16 at most one bf16 ulp of each
output element plus 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import decode_attention as jdecode
from repro.kernels.ops import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.kernels import launch_counts, ref, reset_launch_counts
from repro_torch.kernels.decode_attention import (SPLIT_ALIGN,
                                                  decode_attention,
                                                  decode_splits, q_tile)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=0.0, atol=2e-2)


def _inputs(seed, qshape, kshape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (qshape, kshape, kshape)]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(BF16_TOL if dtype == "bf16" else F32_TOL))


def _pos(*arrays):
    return ([jnp.asarray(a, jnp.int32) for a in arrays],
            [torch.as_tensor(np.asarray(a, np.int32)) for a in arrays])


@pytest.mark.parametrize("b,sq,sk,h,kv,dh", [
    (1, 128, 128, 4, 4, 64),     # MHA square
    (2, 64, 256, 8, 2, 64),      # GQA, kv-longer (cache-style)
    (1, 256, 256, 6, 3, 128),    # odd head group
    (2, 100, 100, 4, 2, 64),     # ragged edge
    (1, 70, 70, 12, 1, 16),      # group 12, narrow heads
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_jax(b, sq, sk, h, kv, dh, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(0, (b, sq, h, dh), (b, sk, kv, dh),
                                      dtype)
    (jqp, jkp), (qp, kp) = _pos(np.arange(sk - sq, sk), np.arange(sk))
    want = jflash(jq, jk, jv, jqp, jkp, block_q=64, block_k=64)
    reset_launch_counts()
    got = flash_attention(q, k, v, qp, kp)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert launch_counts()["flash_attention"] == 0    # CPU: plain version
    _close(got, want, dtype)


@pytest.mark.parametrize("window,softcap,sink", [
    (0, 0.0, 0), (32, 0.0, 0), (32, 0.0, 8), (0, 30.0, 0), (16, 30.0, 4)])
def test_flash_attention_masks_and_softcap_match_jax(window, softcap, sink):
    b, s, h, dh = 1, 192, 4, 32
    (jq, jk, jv), (q, k, v) = _inputs(1, (b, s, h, dh), (b, s, 2, dh), "f32")
    (jpos,), (pos,) = _pos(np.arange(s))
    want = jflash(jq, jk, jv, jpos, jpos, window=window, softcap=softcap,
                  sink=sink, block_q=64, block_k=64)
    got = flash_attention(q, k, v, pos, pos, window=window, softcap=softcap,
                          sink=sink)
    _close(got, want, "f32")


@pytest.mark.parametrize("b,sk,h,kv,dh", [
    (2, 256, 8, 2, 64), (1, 500, 4, 4, 128), (4, 1024, 8, 1, 64),
    (1, 300, 12, 1, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_jax(b, sk, h, kv, dh, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(2, (b, 1, h, dh), (b, sk, kv, dh),
                                      dtype)
    (jqp, jkp), (qp, kp) = _pos([sk - 1], np.arange(sk))
    want = jdecode(jq, jk, jv, jqp, jkp, block_k=128)
    got = decode_attention(q, k, v, qp, kp)
    _close(got, want, dtype)


@pytest.mark.parametrize("window,softcap,sink", [
    (0, 0.0, 0), (40, 0.0, 0), (40, 0.0, 3), (0, 30.0, 0)])
def test_decode_attention_ring_buffer_matches_jax(window, softcap, sink):
    """A wrapped ring buffer: slots hold positions out of order, the last
    ones are empty (-1)."""
    b, sk, h, kv, dh = 1, 128, 4, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(3, (b, 1, h, dh), (b, sk, kv, dh),
                                      "f32")
    filled = 100
    kpos = np.full(sk, -1)
    kpos[:filled] = (np.arange(filled) * 37) % filled + 50
    (jqp, jkp), (qp, kp) = _pos([149], kpos)
    want = jdecode(jq, jk, jv, jqp, jkp, window=window, softcap=softcap,
                   sink=sink, block_k=64)
    got = decode_attention(q, k, v, qp, kp, window=window, softcap=softcap,
                           sink=sink)
    _close(got, want, "f32")


def test_wrappers_reject_bad_arguments():
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 4, 3, 16)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q, k, k, pos, pos)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, q.double(), q.double(), pos, pos)
    with pytest.raises(ValueError, match="q_pos"):
        flash_attention(q, q, q, pos[:2], pos)
    with pytest.raises(ValueError, match=r"\(B,1,H,dh\)"):
        decode_attention(q, q, q, pos[:1], pos)


def _attn_params(rng, d, h, kv, dh):
    p = {"wq": rng.standard_normal((d, h * dh)) * d ** -0.5,
         "wk": rng.standard_normal((d, kv * dh)) * d ** -0.5,
         "wv": rng.standard_normal((d, kv * dh)) * d ** -0.5,
         "wo": rng.standard_normal((h * dh, d)) * (h * dh) ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("window,sink,softcap,capacity", [
    (0, 0, 0.0, 40),      # full attention: Sc = prompt + new tokens
    (16, 0, 0.0, 16),     # ring buffer that wraps in prefill and decode
    (16, 4, 30.0, 20),    # sink prefix + window, softcap
])
def test_attn_apply_with_cache_matches_jax(window, sink, softcap, capacity):
    rng = np.random.default_rng(4)
    b, s, d, h, kv, dh, theta = 2, 24, 64, 4, 2, 16, 10_000.0
    jp, p = _attn_params(rng, d, h, kv, dh)
    x = rng.standard_normal((b, s + 6, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv=kv, d_head=dh, theta=theta, window=window,
              softcap=softcap, sink=sink)
    jcache = jattn.init_kv_cache(b, capacity, kv, dh, jnp.float32)
    cache = attn.init_kv_cache(b, capacity, kv, dh, torch.float32, "cpu")
    jout, jcache = jattn.attn_apply(
        jp, jnp.asarray(x[:, :s]), pos=jnp.arange(s, dtype=jnp.int32),
        cache=jcache, use_kernel=True, **kw)
    out, cache = attn.attn_apply(
        p, torch.from_numpy(x[:, :s]), pos=torch.arange(s, dtype=torch.int32),
        cache=cache, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32_TOL)
    for t in range(s, s + 6):
        jout, jcache = jattn.attn_apply(
            jp, jnp.asarray(x[:, t:t + 1]),
            pos=jnp.asarray([t], jnp.int32), cache=jcache, use_kernel=True,
            **kw)
        out, cache = attn.attn_apply(p, torch.from_numpy(x[:, t:t + 1]),
                                     pos=torch.tensor([t], dtype=torch.int32),
                                     cache=cache, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   **F32_TOL, err_msg=f"decode at {t}")
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **F32_TOL)


def test_sdpa_routes():
    """Sq > 1 takes the prefill wrapper, Sq == 1 the decode wrapper; "ref"
    the plain versions (the same numbers on the CPU)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 5, 2, 16)).astype(
        np.float32))
    pos = torch.arange(5, dtype=torch.int32)
    a = attn.sdpa(q, k, k, pos, pos, use_kernel=True)
    r = attn.sdpa(q, k, k, pos, pos, use_kernel="ref")
    assert torch.equal(a, r)
    d = attn.sdpa(q[:, -1:], k, k, pos[-1:], pos)
    torch.testing.assert_close(d, a[:, -1:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, None, "reff", "rank", 1])
def test_sdpa_rejects_unknown_use_kernel(use_kernel):
    """Only True and "ref" name a route; False (the JAX XLA route) and
    anything else raise instead of quietly taking the kernels."""
    q = torch.zeros((1, 3, 2, 16))
    pos = torch.arange(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="use_kernel"):
        attn.sdpa(q, q, q, pos, pos, use_kernel=use_kernel)


# --- the kernels' designs, emulated on the CPU, within phase 4's bounds --------
def _phase4_close(got, want, dtype):
    """chip_smoke.py phase 4's bound: f32 max |diff| <= 1e-5; bf16 at most
    one bf16 ulp (at the larger magnitude) plus 1e-5."""
    g = got.float() if isinstance(got, torch.Tensor) else \
        torch.from_numpy(np.asarray(got, np.float32))
    w = want.float() if isinstance(want, torch.Tensor) else \
        torch.from_numpy(np.asarray(want, np.float32))
    assert bool(torch.isfinite(g).all())
    if dtype == "f32":
        assert float((g - w).abs().max()) <= 1e-5
        return
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    assert float((((g - w).abs() - 1e-5) / ulp).max()) <= 1.0


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,window,sink,softcap,k_off", [
    (1, 100, 100, 4, 2, 64, 0, 0, 0.0, 0),       # Sq not a multiple of 16
    (2, 37, 90, 4, 4, 16, 0, 0, 30.0, 0),        # dh 16, ragged, softcap
    (1, 70, 70, 2, 1, 128, 32, 8, 0.0, 0),       # dh 128, window + sink
    (1, 50, 128, 4, 2, 32, 0, 0, 0.0, 100),      # rows with no visible key
    (1, 1200, 1200, 5, 1, 64, 1024, 128, 0.0, 0),  # Hymba: group 5, its
])                                                 # window and sink
def test_flash_split_p_emulation_within_phase4_bounds(b, sq, sk, h, kv, dh,
                                                      window, sink, softcap,
                                                      k_off):
    """The tensor-core route's rounding (bf16 products summed in f32, P in
    bf16 hi + lo) against the plain version and the JAX kernel."""
    (jq, jk, jv), (q, k, v) = _inputs(7, (b, sq, h, dh), (b, sk, kv, dh),
                                      "bf16")
    (jqp, jkp), (qp, kp) = _pos(np.arange(sk - sq, sk),
                                np.arange(sk) + k_off)
    kw = dict(window=window, softcap=softcap, sink=sink)
    got = ref.flash_attention_split_p(q, k, v, qp, kp, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _phase4_close(got, ref.flash_attention_ref(q, k, v, qp, kp, **kw),
                  "bf16")
    # The JAX wrapper pads Sk to its block with masked (-1e30, not -inf)
    # slots, which a row with no visible key averages over as well: such
    # rows are compared only where Sk is a multiple of the block.
    blk = 256 if sq > 512 else 64
    want = jflash(jq, jk, jv, jqp, jkp, block_q=blk, block_k=blk, **kw)
    _phase4_close(got, want, "bf16")
    # before the output's rounding: the split P alone stays within the f32
    # bound (on the bf16 values, held in f32)
    q32, k32, v32 = q.float(), k.float(), v.float()
    _phase4_close(ref.flash_attention_split_p(q32, k32, v32, qp, kp, **kw),
                  ref.flash_attention_ref(q32, k32, v32, qp, kp, **kw),
                  "f32")


def _decode_kpos(sc, kind):
    """Ring-buffer positions: ``full`` (0..Sc-1), ``tail`` (the last third
    empty, so whole splits hold only empty slots), ``wrapped`` (positions
    out of order, some slots empty), ``none`` (every slot empty)."""
    if kind == "full":
        return np.arange(sc)
    if kind == "tail":
        return np.where(np.arange(sc) < sc - sc // 3, np.arange(sc), -1)
    if kind == "none":
        return np.full(sc, -1)
    kpos = (np.arange(sc) * 37) % sc + 50
    kpos[5::11] = -1
    return kpos


@pytest.mark.parametrize("b,sc,h,kv,dh,kind,window,sink,softcap", [
    (2, 40, 4, 2, 64, "full", 0, 0, 0.0),          # Sc < one split
    (1, 65, 4, 4, 64, "full", 0, 0, 0.0),          # one past a boundary
    (3, 300, 8, 2, 16, "tail", 0, 0, 0.0),         # empty splits, dh 16
    (1, 129, 4, 1, 128, "wrapped", 64, 4, 30.0),   # dh 128, ring, masks
    (2, 200, 4, 2, 32, "none", 0, 0, 0.0),         # no visible key at all
    (1, 1152, 5, 1, 64, "wrapped", 1024, 128, 0.0),  # Hymba's ring, group 5
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_split_emulation_within_phase4_bounds(b, sc, h, kv, dh, kind,
                                                     window, sink, softcap,
                                                     dtype):
    """Per-split partial softmax states and their merge, with the splits
    the wrapper would choose on a 132-SM card, against the plain version
    and the JAX kernel."""
    (jq, jk, jv), (q, k, v) = _inputs(8, (b, 1, h, dh), (b, sc, kv, dh),
                                      dtype)
    kpos = _decode_kpos(sc, kind)
    (jqp, jkp), (qp, kp) = _pos([int(max(kpos.max(), 0)) + 3], kpos)
    n_split, split_len = decode_splits(sc, b * kv * -(-(h // kv) //
                                                       q_tile(h // kv)), 132)
    if kind in ("tail", "wrapped") and sc > 128:
        assert n_split > 1
    kw = dict(window=window, softcap=softcap, sink=sink)
    got = ref.decode_attention_splits(q, k, v, qp, kp, n_split=n_split,
                                      split_len=split_len, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    _phase4_close(got, ref.decode_attention_ref(q, k, v, qp, kp, **kw),
                  dtype)
    # one JAX key block where no slot is visible: its padding to the block
    # would add masked slots to the average (see the flash test above)
    want = jdecode(jq, jk, jv, jqp, jkp, block_k=sc if kind == "none" else
                   128, **kw)
    _phase4_close(got, want, dtype)


@pytest.mark.parametrize("n_split,split_len", [(1, 64), (2, 64), (4, 32),
                                               (9, 16)])
def test_decode_split_emulation_any_cut(n_split, split_len):
    """Any cut of the cache into non-empty ranges gives the plain result,
    with masked splits merged at weight 0 (or 1 when nothing is seen)."""
    rng = np.random.default_rng(9)
    sc = (n_split - 1) * split_len + 1
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 1, 6, 16), (2, sc, 3, 16), (2, sc, 3, 16)))
    for kpos in (_decode_kpos(sc, "tail"), _decode_kpos(sc, "none")):
        qp, kp = torch.tensor([sc + 1]), torch.as_tensor(kpos)
        got = ref.decode_attention_splits(q, k, v, qp, kp, n_split=n_split,
                                          split_len=split_len, window=8)
        _phase4_close(got, ref.decode_attention_ref(q, k, v, qp, kp,
                                                    window=8), "f32")
    with pytest.raises(ValueError, match="non-empty"):
        ref.decode_attention_splits(q, k, v, qp, kp, n_split=n_split + 1,
                                    split_len=split_len)


@pytest.mark.parametrize("sc,blocks,sms,want", [
    (2048, 32, 132, (8, 256)),     # StableLM: 256 blocks of 256 slots
    (1152, 5, 132, (18, 64)),      # Hymba's ring: 90 blocks of 64
    (40, 32, 132, (1, 64)),        # smaller than one split
    (2048, 512, 132, (1, 2048)),   # the grid alone fills the card
    (65, 1, 132, (2, 64)),         # one past a split boundary
    (4300, 24, 132, (10, 448)),
])
def test_decode_splits(sc, blocks, sms, want):
    n, length = decode_splits(sc, blocks, sms)
    assert (n, length) == want
    assert length % SPLIT_ALIGN == 0
    assert (n - 1) * length < sc <= n * length


def test_decode_splits_cover_the_cache():
    for sc in (1, 2, 63, 64, 65, 127, 128, 129, 1000, 2048, 4300, 32768):
        for blocks in (1, 5, 32, 96, 264, 1000):
            n, length = decode_splits(sc, blocks, 132)
            assert (n - 1) * length < sc <= n * length
            assert length % SPLIT_ALIGN == 0 and n >= 1
            assert n * blocks <= max(blocks, 2 * 132 + blocks)


def test_q_tile():
    assert [q_tile(g) for g in (1, 2, 3, 4, 5, 8, 9, 12, 24)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 8]
