"""The port's attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``use_kernel=True``,
as tests/test_kernels.py does); the port's wrappers run their plain
versions for CPU tensors.  Inputs come from a numpy seed and reach both
packages as the same numbers (bf16 inputs are rounded from the same f32
draws).  Tolerances: f32 ``rtol=1e-5, atol=1e-6`` (the two differ only in
the order of f32 sums: one softmax over the whole key axis against an
online softmax over key blocks); bf16 ``atol=2e-2`` (one bf16 rounding of
outputs below 4 in magnitude, as tests/test_kernels.py allows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import decode_attention as jdecode
from repro.kernels.ops import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import decode_attention
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
