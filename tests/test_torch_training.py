"""The port's training path (``repro_torch.training``, the losses of
``repro_torch.models.transformer`` and the differentiable kernel wrappers)
against the JAX package's, on the CPU, in f32.

Both packages run the same weights (the JAX ``init_params`` tree through
``convert.lm_params_from_arrays``) and the same numpy batches.  The JAX
gradients come from its XLA route (``use_kernel=False``), which is what its
trainer runs; the port's from its kernel route, whose autograd Functions
recompute the plain versions in the backward.  Forwards agree to
``rtol=1e-5, atol=1e-5`` and gradients to ``rtol=1e-4`` and an ``atol`` of
1e-6 times the larger of 1 and the leaf's largest |gradient|: Hymba's
embedding and meta-token gradients reach 4 (rms_norm divides by the
0.02-scale embeddings' RMS), and their f32 noise scales with them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_arrays
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, gla_chunk_plain
from repro_torch.models import transformer as tf
from repro_torch.training import compression, optimizer
from repro_torch.training.optimizer import OptConfig, init_opt, tree_leaves
from repro_torch.training.train_loop import (TrainConfig, make_train_step,
                                             value_and_grad)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
ARCHS = sorted(registry.ARCHS)
B, S = 2, 12


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jregistry.smoke(arch), dtype="float32",
                               use_kernel=False, **kw)
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32", **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jtf.init_params(jax.random.key(5), jcfg))


def _batch(cfg, seed, b=B, s=S, ignore=True):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s))
    if ignore:
        labels[0, :3] = -100                # ignored positions
    out = {"labels": labels}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s))
    else:
        out["embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def stacked(params) -> dict:
    """The port's tree as the JAX package's: per-layer dicts stacked into
    ``[L, ...]`` leaves, as numpy f32."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([l[k] for l in layers]) for k in layers[0]}
        return np.stack([l.detach().float().numpy() for l in layers])
    out = {k: v.detach().float().numpy() for k, v in params.items()
           if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out


def _assert_trees(got, want, *, rtol, atol, scaled=False):
    """Leaf by leaf; ``scaled``: atol times max(1, the leaf's max |want|)."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        a = atol * max(1.0, float(np.abs(w).max())) if scaled else atol
        np.testing.assert_allclose(flat_g[path], w, rtol=rtol, atol=a,
                                   err_msg=jax.tree_util.keystr(path))


# --- losses -----------------------------------------------------------------
def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((2, 5, 11), (2, 5, 3, 11)):
        logits = rng.standard_normal(shape).astype(np.float32) * 3
        labels = rng.integers(0, 11, shape[:-1])
        labels.reshape(-1)[::4] = -100
        want = jtf.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
        got = tf.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), **FWD)
        g = jax.grad(lambda x: jtf.cross_entropy(x, jnp.asarray(labels)))(
            jnp.asarray(logits))
        t = torch.from_numpy(logits).requires_grad_()
        tf.cross_entropy(t, torch.from_numpy(labels)).backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD)
    # every label ignored: 0, not a division by zero
    z = tf.cross_entropy(torch.zeros(1, 2, 3), torch.full((1, 2), -100))
    assert float(z) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _jax_params(arch)
    batch = _batch(cfg, 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _jb(batch))
    params = lm_params_from_arrays(tree, cfg, device="cpu")
    (loss, m), grads = value_and_grad(params, cfg, _tb(batch))
    np.testing.assert_allclose(float(loss), float(jl), **FWD)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **FWD)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), **FWD)
    assert (float(m["aux"]) > 0) == (cfg.family == "moe")
    _assert_trees(stacked(grads), jg, **GRAD, scaled=True)


def test_musicgen_labels_broadcast_over_heads():
    _, cfg = _cfgs("musicgen-large")
    assert cfg.out_heads > 1
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    b = _tb(_batch(cfg, 2))
    l2, m2 = tf.loss_fn(params, cfg, b)
    lab = b["labels"][..., None].expand(*b["labels"].shape, cfg.out_heads)
    l3, _ = tf.loss_fn(params, cfg, dict(b, labels=lab))
    assert float(l2) == float(l3) and float(m2["aux"]) == 0.0


# --- the optimizer ------------------------------------------------------------
def test_schedule_matches_jax():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jc = jopt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = optimizer.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(jopt.schedule(jc, jnp.int32(s))),
                                   rtol=1e-6, atol=0)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal(7).astype(np.float32),
            "b": {"c": rng.standard_normal((3, 4)).astype(np.float32)}}
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    got = optimizer.global_norm(
        optimizer.tree_map(torch.from_numpy, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _lm_tree(rng):
    """A parameter tree with the LM's shapes of rank: stacked layer leaves
    in JAX, per-layer ones in the port (norms [L, d] / [d], the hybrid
    scalars [L] / [])."""
    L, d = 3, 8
    jt = {"embed": rng.standard_normal((16, d)),
          "final_norm": rng.standard_normal(d),
          "layers": {"ln1": rng.standard_normal((L, d)),
                     "b_attn": rng.standard_normal(L),
                     "attn": {"wq": rng.standard_normal((L, d, d))}}}
    jt = jax.tree.map(lambda x: x.astype(np.float32), jt)
    return jt, optimizer.tree_map(lambda x: torch.from_numpy(x.copy()),
                                  _per_layer(jt, L))


def _per_layer(jt, n):
    """The stacked tree of :func:`_lm_tree` as the port's per-layer one."""
    return {"embed": jt["embed"], "final_norm": jt["final_norm"],
            "layers": [{"ln1": jt["layers"]["ln1"][i],
                        "b_attn": np.asarray(jt["layers"]["b_attn"][i]),
                        "attn": {"wq": jt["layers"]["attn"]["wq"][i]}}
                       for i in range(n)]}


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_apply_updates_matches_jax_over_steps(wd):
    """The same grads in both packages for 4 steps; the stacked norms
    (``ln1`` [L, d] in JAX) decay, ``b_attn`` ([L]) and ``final_norm`` do
    not, as in the reference."""
    rng = np.random.default_rng(4)
    jt, pt = _lm_tree(rng)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                    weight_decay=wd, clip_norm=3.0)
    jc = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        weight_decay=wd, clip_norm=3.0)
    jp = jax.tree.map(jnp.asarray, jt)
    jo = jopt.init_opt(jp)
    po = init_opt(pt)
    dec = optimizer.decays(pt)
    assert dec["layers"][0] == {"ln1": True, "b_attn": False,
                                "attn": {"wq": True}}
    assert dec["final_norm"] is False and dec["embed"] is True
    for step in range(4):
        jg = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 2.0
                                     ).astype(np.float32), jt)
        pg = _per_layer(jg, 3)
        jp, jo, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, jg),
                                        jo, jc)
        pt, po, pm = optimizer.apply_updates(
            pt, optimizer.tree_map(torch.from_numpy, pg), po, cfg)
        assert int(po.step) == step + 1
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for name, got, want in (("params", pt, jp), ("master", po.master,
                                                     jo.master),
                                ("m", po.m, jo.m), ("v", po.v, jo.v)):
            _assert_trees(stacked(got), want, rtol=1e-5, atol=1e-7)


def test_adamw_decreases_quadratic_loss():
    w = {"a": torch.tensor([2.0, -3.0]), "b": torch.tensor([[1.5]])}
    opt = init_opt(w)
    cfg = OptConfig(lr=0.05, warmup_steps=0, total_steps=200,
                    weight_decay=0.0)
    loss = lambda p: torch.sum(p["a"] ** 2) + torch.sum(p["b"] ** 2)
    l0 = float(loss(w))
    for _ in range(100):
        g = {k: 2 * v for k, v in w.items()}
        w, opt, _ = optimizer.apply_updates(w, g, opt, cfg)
    assert float(loss(w)) < 0.05 * l0


def test_grad_clip_reports_pre_clip_norm_and_stays_finite():
    w = {"a": torch.ones(4)}
    opt = init_opt(w)
    cfg = OptConfig(lr=1.0, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    w, opt, m = optimizer.apply_updates(w, {"a": torch.full((4,), 1e6)},
                                        opt, cfg)
    assert float(m["grad_norm"]) > 1e6
    assert bool(torch.isfinite(w["a"]).all())
    assert bool(torch.isfinite(opt.v["a"]).all())


def test_bf16_params_take_the_master_rounded():
    w = {"a": torch.ones((2, 3), dtype=torch.bfloat16)}
    opt = init_opt(w)
    assert opt.master["a"].dtype == torch.float32
    w, opt, _ = optimizer.apply_updates(
        w, {"a": torch.full((2, 3), 0.5, dtype=torch.bfloat16)}, opt,
        OptConfig(lr=0.1, warmup_steps=0))
    assert w["a"].dtype == torch.bfloat16
    assert torch.equal(w["a"], opt.master["a"].to(torch.bfloat16))


# --- compression --------------------------------------------------------------
def test_quantize_rounds_half_to_even_like_jnp_round():
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -300.0]) / 127.0
    scale = torch.tensor(1.0)
    got = compression.quantize_int8(g, scale)
    want = jcomp.quantize_int8(jnp.asarray(g.numpy()), jnp.float32(1.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int8


def test_compress_error_feedback_matches_jax():
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal(300).astype(np.float32) * 3,
            "b": {"c": rng.standard_normal((4, 5)).astype(np.float32)}}
    jerr = jcomp.init_error_buffer(jax.tree.map(jnp.asarray, tree))
    perr = compression.init_error_buffer(
        optimizer.tree_map(torch.from_numpy, tree))
    for _ in range(5):
        jq, jerr = jcomp.compress_error_feedback(
            jax.tree.map(jnp.asarray, tree), jerr)
        pq, perr = compression.compress_error_feedback(
            optimizer.tree_map(torch.from_numpy, tree), perr)
        for got, want in ((pq, jq), (perr, jerr)):
            _assert_trees(optimizer.tree_map(lambda x: x.numpy(), got), want,
                          rtol=1e-6, atol=1e-6)


def test_compression_error_feedback_converges():
    g = {"w": torch.randn(256, generator=torch.Generator().manual_seed(0))
         * 3.0}
    err = compression.init_error_buffer(g)
    acc_q = torch.zeros(256)
    for _ in range(50):
        q, err = compression.compress_error_feedback(g, err)
        acc_q = acc_q + q["w"]
    resid = float(torch.max(torch.abs(acc_q - g["w"] * 50)))
    scale = float(torch.max(torch.abs(g["w"])))
    assert resid < 2.5 * scale / 127 * 50 ** 0.5 + scale / 64


def test_compress_pod_reduce_is_the_identity_without_a_pod_axis():
    g = {"w": torch.ones(3)}
    assert compression.compress_pod_reduce(g) is g


# --- the train step -----------------------------------------------------------
@pytest.mark.parametrize("nm", [1, 2])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "hymba-1.5b"])
def test_train_step_matches_jax_three_steps(arch, nm):
    """Three steps with the config's remat ("full": a checkpoint per
    block); AdamW's eps is 1e-3 here so that an update is a smooth
    function of its gradient (with eps 1e-8 a gradient of order 1e-8,
    well inside f32 noise, sets an update of the order of lr)."""
    jcfg, cfg = _cfgs(arch)
    assert cfg.remat == "full"
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    tree = _jax_params(arch)
    jstep = jax.jit(jtl.make_train_step(jcfg, jtl.TrainConfig(
        microbatches=nm, opt=jopt.OptConfig(**opt_kw))))
    pstep = make_train_step(cfg, TrainConfig(microbatches=nm,
                                             opt=OptConfig(**opt_kw)))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jopt.init_opt(jp)
    params = lm_params_from_arrays(tree, cfg, device="cpu")
    opt = init_opt(params)
    for step in range(3):
        batch = _batch(cfg, 10 + step, b=4)
        jp, jo, jm = jstep(jp, jo, _jb(batch))
        params, opt, m = pstep(params, opt, _tb(batch))
        assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **FWD,
                                       err_msg=k)
        if nm > 1:
            assert float(m["aux"]) == 0.0
        _assert_trees(stacked(params), jp, **FWD)
        _assert_trees(stacked(opt.m), jo.m, **GRAD, scaled=True)


def test_microbatched_grads_match_full_batch():
    cfg = dataclasses.replace(registry.smoke("stablelm-1.6b"),
                              dtype="float32", remat="none")
    # every label counts, so each microbatch's mean has the same weight
    batch = _tb(_batch(cfg, 7, b=8, s=16, ignore=False))
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    outs = []
    for nm in (1, 4):
        p = optimizer.tree_map(torch.clone, params)
        p, o, m = make_train_step(cfg, TrainConfig(microbatches=nm))(
            p, init_opt(p), batch)
        outs.append((p, o, m))
    np.testing.assert_allclose(float(outs[0][2]["loss"]),
                               float(outs[1][2]["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(outs[0][1].m), tree_leaves(outs[1][1].m)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


# --- the autograd Functions ---------------------------------------------------
def _grads(fn, ins, w):
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum(torch.sum(o * wi) for o, wi in zip(outs, w))
    return torch.autograd.grad(loss, [t for t in ins
                                      if isinstance(t, torch.Tensor)
                                      and t.requires_grad])


@pytest.mark.parametrize("window,softcap,sink", [(0, 0.0, 0), (5, 0.0, 0),
                                                 (6, 30.0, 2)])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (6, 1)])
def test_flash_attention_function_grads_equal_plain_autograd(h, kv, window,
                                                             softcap, sink):
    g = torch.Generator().manual_seed(h * 10 + kv + window)
    b, s, dh = 2, 13, 16
    q, k, v = (torch.randn(b, s, n, dh, generator=g).requires_grad_()
               for n in (h, kv, kv))
    pos = torch.arange(s, dtype=torch.int32)
    w = [torch.randn(b, s, h, dh, generator=g)]
    opts = (window, softcap, sink)
    got = _grads(lambda *a: ops.flash_attention(*a, pos, pos, *opts),
                 (q, k, v), w)
    want = _grads(lambda *a: flash_attention_ref(
        *a, pos, pos, window=window, softcap=softcap, sink=sink), (q, k, v),
        w)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    # only the inputs that need a gradient get one
    qd = q.detach()
    out = ops.flash_attention(qd, k, v, pos, pos, *opts)
    gk, = torch.autograd.grad(torch.sum(out * w[0]), [k])
    assert gk.shape == k.shape


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("with_state", [False, True])
def test_gla_function_grads_equal_plain_autograd(chunk, normalize,
                                                 with_state):
    g = torch.Generator().manual_seed(chunk + 2 * normalize)
    b, s, h, dk, dv = 2, 16, 2, 8, 12
    q, k = (torch.randn(b, s, h, dk, generator=g).requires_grad_()
            for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=g).requires_grad_()
    lf = (torch.nn.functional.logsigmoid(torch.randn(b, s, h, generator=g))
          ).requires_grad_()
    li = (torch.randn(b, s, h, generator=g) * 0.5).requires_grad_()
    s0 = n0 = None
    if with_state:
        s0 = torch.randn(b, h, dk, dv, generator=g).requires_grad_()
        n0 = torch.randn(b, h, dk, generator=g).requires_grad_()
    w = [torch.randn(b, s, h, dv, generator=g),
         torch.randn(b, h, dk, dv, generator=g),
         torch.randn(b, h, dk, generator=g)]
    ins = (q, k, v, lf, li, s0, n0)
    got = _grads(lambda *a: ops.gla_chunk(*a, chunk, normalize), ins, w)

    def plain(q, k, v, lf, li, s0, n0):
        init = None if s0 is None else (s0, n0)
        y, (st, n) = gla_chunk_plain(q, k, v, lf, li, chunk=chunk,
                                     normalize=normalize, init_state=init)
        return y, st, n
    want = _grads(plain, ins, w)
    assert len(got) == (7 if with_state else 5)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_gla_plain_backward_is_finite_where_the_decay_overflows():
    """Strong forget gates over a long chunk make exp(b_t - b_s) overflow
    above the diagonal; those entries are masked, and the gradient stays
    finite."""
    g = torch.Generator().manual_seed(0)
    b, s, h, d = 1, 64, 1, 8
    q, k, v = (torch.randn(b, s, h, d, generator=g).requires_grad_()
               for _ in range(3))
    lf = torch.full((b, s, h), -3.0, requires_grad=True)
    li = torch.zeros(b, s, h, requires_grad=True)
    y, _ = gla_chunk_plain(q, k, v, lf, li, chunk=64)
    grads = torch.autograd.grad(y.sum(), [q, k, v, lf, li])
    assert all(bool(torch.isfinite(x).all()) for x in grads)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "xlstm-350m",
                                  "hymba-1.5b"])
def test_kernel_route_grads_equal_plain_route(arch):
    """The model's gradients through the Functions (use_kernel=True) equal
    those of the plain route (use_kernel="ref"), bit for bit on the CPU."""
    _, cfg = _cfgs(arch)
    params = tf.init_params(torch.Generator().manual_seed(2), cfg)
    batch = _tb(_batch(cfg, 3))
    outs = [value_and_grad(params, dataclasses.replace(cfg, use_kernel=u),
                           batch) for u in (True, "ref")]
    assert float(outs[0][0][0]) == float(outs[1][0][0])
    for a, b_ in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
