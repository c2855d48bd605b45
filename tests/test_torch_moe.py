"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py`` on the CPU.

Both run the same numpy weights and inputs.  In f32 the output and the
load-balance loss agree to ``rtol=1e-5, atol=1e-5`` and the gradients with
respect to ``x``, the router and every expert leaf to ``rtol=1e-4,
atol=1e-6`` (``jax.grad`` of the same scalar); in bf16 the output agrees to
bf16 rounding.  The expert choice and the kept slot of every (token,
choice) equal the reference's exactly, at capacity factors that drop
choices (0.5, 1.25) and one that drops none (8.0), with a token of zeros
whose router probabilities tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

B, S, D, F_, E = 2, 8, 16, 24, 4
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
ACTS = ["swiglu", "geglu", "gelu", "relu2"]


def _inputs(act, seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": (rng.standard_normal((D, E)) * D ** -0.5).astype(
        np.float32), "experts": {}}
    shapes = {"w_up": (E, D, F_), "w_down": (E, F_, D)}
    if act in ("swiglu", "geglu"):
        shapes["w_gate"] = (E, D, F_)
    for k, s in shapes.items():
        p["experts"][k] = (rng.standard_normal(s) * s[1] ** -0.5).astype(
            np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x[0, 0] = 0.0               # equal router probabilities: a tie
    w = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x, w


def _tree(p, f):
    return {k: _tree(v, f) if isinstance(v, dict) else f(v, k)
            for k, v in p.items()}


def _jax_choices(p, x, top_k, cf):
    """The reference's expert choice and slot of every flattened choice
    (its own top_k and cumulative count, as ``moe_apply`` computes them)."""
    xt = jnp.asarray(x).reshape(1, B * S, D)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt,
                                      jnp.asarray(p["router"])), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    cap = int(max(top_k * B * S * cf / E, 4))
    flat_e = idx.reshape(1, -1)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - oh,
                              flat_e[..., None], axis=2)[..., 0]
    keep = pos < cap
    return (np.asarray(flat_e[0]), np.asarray(jnp.where(keep, pos,
                                                        cap - 1)[0]),
            np.asarray(keep[0]))


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_choices_and_slots_equal_jax(top_k, cf):
    p, x, _ = _inputs("swiglu", seed=top_k)
    want = _jax_choices(p, x, top_k, cf)
    xt = torch.from_numpy(x).reshape(B * S, D)
    _, _, idx = moe.route(torch.from_numpy(p["router"]), xt, top_k)
    cap = moe.capacity(top_k, B * S, cf, E)
    got = moe.dispatch(idx[None], E, cap)           # one group
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w)
    # the zero token ties: lower expert ids first, as lax.top_k
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(top_k))
    if cf < 8.0 and top_k == 2:
        assert not want[2].all()            # some choices are dropped
    if cf == 8.0:
        assert want[2].all()


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("act", ACTS)
def test_moe_apply_and_grads_match_jax_f32(act, top_k, cf):
    p, x, w = _inputs(act, seed=3)
    jp = _tree(p, lambda a, _: jnp.asarray(a))

    def jloss(jp, x):
        out, aux = jmoe.moe_apply(jp, x, top_k=top_k, act=act,
                                  capacity_factor=cf)
        return jnp.sum(out * jnp.asarray(w)) + 0.5 * aux, (out, aux)

    (_, (jout, jaux)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    tp = _tree(p, lambda a, _: torch.from_numpy(a).requires_grad_())
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(tp, tx, top_k=top_k, act=act,
                             capacity_factor=cf)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **FWD)
    loss = torch.sum(out * torch.from_numpy(w)) + 0.5 * aux
    leaves = [tx, tp["router"], *tp["experts"].values()]
    got = torch.autograd.grad(loss, leaves)
    want = [gx, gp["router"], *(gp["experts"][k] for k in tp["experts"])]
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("act", ACTS)
def test_moe_apply_matches_jax_bf16(act, top_k, cf):
    """bf16 weights and activations with the f32 router, as the models
    hold them: output within bf16 rounding, the aux loss in f32."""
    p, x, _ = _inputs(act, seed=4)
    bf = lambda a, k: a if k == "router" else a.astype(jnp.bfloat16)
    jp = _tree(p, lambda a, k: jnp.asarray(bf(a, k)))
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), top_k=top_k,
                                act=act, capacity_factor=cf)
    tp = _tree(p, lambda a, k: torch.from_numpy(a).to(
        torch.float32 if k == "router" else torch.bfloat16))
    out, aux = moe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                             top_k=top_k, act=act, capacity_factor=cf)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(aux), float(jaux), **FWD)


def test_init_moe_shapes_and_dtypes():
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, D, F_, E, "swiglu", torch.bfloat16)
    assert p["router"].shape == (D, E) and p["router"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in p["experts"].items()} == {
        "w_up": (E, D, F_), "w_gate": (E, D, F_), "w_down": (E, F_, D)}
    assert all(v.dtype == torch.bfloat16 for v in p["experts"].values())
    assert "w_gate" not in moe.init_moe(g, D, F_, E, "gelu")["experts"]
    with pytest.raises(ValueError, match="unknown mlp act"):
        moe._expert_ffn(p["experts"], torch.zeros(E, 4, D,
                                                  dtype=torch.bfloat16),
                        "tanh")


def test_capacity_is_the_references_float_formula():
    # int(max(k * T * cf / E, 4)) in Python floats, floor 4
    assert moe.capacity(2, 2048, 1.25, 16) == 320
    assert moe.capacity(2, 1, 1.25, 16) == 4
    assert moe.capacity(1, 10, 0.3, 3) == 4
    assert moe.capacity(2, 7, 1.25, 3) == int(2 * 7 * 1.25 / 3)
