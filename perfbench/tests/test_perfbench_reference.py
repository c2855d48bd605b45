"""The plain reference against the program's plain path (its CPU route)
on tiny configurations in float32: prefill logits and cache, the train
loss and gradients, and one AdamW step."""
import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import common, dense
from perfbench.tests import tiny

FAMILIES = [tiny.STARCODER, tiny.DEEPSEEK]


def _f32_model(fam):
    cfg = tiny.config(dtype="float32", **fam)
    return cfg, harness.port_config(cfg)


@pytest.mark.parametrize("fam", FAMILIES, ids=["starcoder", "deepseek"])
def test_prefill_logits_and_cache(fam):
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import make_serve_steps
    cfg, pc = _f32_model(fam)
    params = weights.make(cfg, 3, "cpu", torch.float32)
    s = 80                                    # past the 32-key window
    tokens = torch.randint(0, 256, (1, s),
                           generator=torch.Generator().manual_seed(1))
    cache = tf.init_cache(pc, 1, 128, device="cpu")
    logits, cache = make_serve_steps(pc)[0](params, cache,
                                            {"tokens": tokens})
    kv = {}
    want = dense.Model(cfg).prefill(
        params, lambda li: params["layers"][li], 2, tokens[0],
        on_kv=lambda li, k, v: kv.__setitem__(li, (k, v)))
    scale = want.abs().max()
    assert (logits[0, -1] - want).abs().max() <= 1e-5 * scale
    ring = cache[0]["attn"]["k"].shape[1]
    pos = torch.arange(max(0, s - ring), s)
    for li, (k, v) in kv.items():
        c = cache[li]["attn"]
        slots = pos % ring
        assert torch.equal(c["kpos"][slots].long(), pos)
        torch.testing.assert_close(c["k"][0, slots], k[pos], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(c["v"][0, slots], v[pos], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("fam", FAMILIES, ids=["starcoder", "deepseek"])
def test_train_loss_gradients_and_adamw(fam):
    from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                                init_opt, tree_leaves)
    from repro_torch.training.train_loop import value_and_grad
    cfg, pc = _f32_model(fam)
    params = weights.make(cfg, 5, "cpu", torch.float32)
    t = torch.randint(0, 256, (2, 33),
                      generator=torch.Generator().manual_seed(2))
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    (loss, _), grads = value_and_grad(params, pc, batch)

    ref = weights.tree_map(lambda w: w.clone().requires_grad_(), params)
    model = dense.Model(cfg)
    want = sum(model.loss(ref, batch["tokens"][r], batch["labels"][r]) / 2
               for r in range(2))
    want.backward()
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    got_g, want_g = tree_leaves(grads), [w.grad for _, w in
                                         weights.leaf_paths(ref)]
    for g, w in zip(got_g, want_g, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)

    opt = tiny.TRAIN_OPT
    state = init_opt(params)
    new, _, _ = apply_updates(params, grads, state, OptConfig(**opt))
    paths = weights.leaf_paths(ref)
    leaves = [w.detach().clone() for _, w in paths]
    decay = [common.decays(p, w) for p, w in paths]
    common.adamw(leaves, [g.clone() for g in got_g],
                [torch.zeros_like(x) for x in leaves],
                [torch.zeros_like(x) for x in leaves], decay, opt, 1)
    for a, b in zip(tree_leaves(new), leaves, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_window_matches_a_plain_mask():
    """The reference's query blocks against a dense masked softmax."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(70, 4, 8, generator=g)
    k = torch.randn(70, 2, 8, generator=g)
    v = torch.randn(70, 2, 8, generator=g)
    for window in (0, 9):
        got = common.attention(q, k, v, window, block=16)
        kk, vv = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
        logits = torch.einsum("qhd,shd->hqs", q, kk) * 8 ** -0.5
        i = torch.arange(70)
        keep = i[None] <= i[:, None]
        if window:
            keep &= i[None] > i[:, None] - window
        p = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
        torch.testing.assert_close(got, torch.einsum("hqs,shd->qhd", p, vv))
