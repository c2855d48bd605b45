"""The port's sharding planner (``repro_torch.sharding``), its activation
constraints, the q-chunked plain attention and the MoE layer's
data-parallel groups against the JAX package on the CPU.

The planner is pure Python on both sides, so its specs must equal JAX's
entry for entry: every leaf of every registry arch's full-size parameter
tree (the port's per-layer leaf ``/layers/i/...`` against JAX's stacked
``/layers/...`` with its leading L entry dropped) on shape-only 1x1,
16x16 and 2x16x16 meshes, with TP and FSDP on and off; every cache leaf
of every arch's decode_32k cache; the batch specs and the activation
rules.  The q-chunked plain attention equals ``flash_attention_ref`` bit
for bit below its threshold and JAX's ``_sdpa_chunked`` to rtol 1e-5 in
f32; ``moe_apply`` with 4 groups equals JAX's with its
``dp_group_count`` patched to 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.sharding import specs as jspecs
from repro_torch.configs import registry
from repro_torch.kernels import ref
from repro_torch.launch.cells import _abstract_cache
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.sharding import activation, specs

MESHES = {"1x1": AbstractMesh(("data", "model"), (1, 1)),
          "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
ARCHS = sorted(registry.ARCHS)


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/" + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in path)
        out[key] = leaf
    return out


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _stacked_key(path: str) -> str:
    """``/layers/3/attn/wq`` -> ``/layers/attn/wq``; a cache leaf
    ``/3/attn/k`` -> ``/attn/k``."""
    parts = path.split("/")
    return "/".join(p for p in parts if not p.isdigit())


@pytest.fixture(scope="module")
def trees():
    """Both packages' full-size abstract parameter trees, by arch."""
    return {a: (jtf.abstract_params(jregistry.get(a)),
                tf.abstract_params(registry.get(a))) for a in ARCHS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_on_every_leaf(trees, arch, mesh_name):
    mesh = MESHES[mesh_name]
    jtree, ptree = trees[arch]
    jl, pl = _jax_leaves(jtree), _port_leaves(ptree)
    n_layers = registry.get(arch).n_layers
    # the same leaves: the port's per-layer leaves are JAX's stacked ones
    assert {_stacked_key(k) for k in pl} == set(jl)
    for k, t in pl.items():
        j = jl[_stacked_key(k)]
        stacked = "/layers/" in k
        assert tuple(j.shape) == ((n_layers,) if stacked else ()) \
            + tuple(t.shape), k
        assert str(t.dtype).split(".")[-1] == str(j.dtype), k
    for fsdp in (True, False):
        for tp in (True, False):
            jt = jspecs.tree_specs(mesh, jtree, fsdp=fsdp, tp=tp)
            pt = specs.tree_specs(mesh, ptree, fsdp=fsdp, tp=tp)
            jsp = dict(zip(jl, jax.tree.leaves(
                jt, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))))
            for k, spec in _port_leaves(pt).items():
                assert isinstance(spec, specs.P)
                want = tuple(jsp[_stacked_key(k)])
                if "/layers/" in k:
                    assert want[0] is None, k
                    want = want[1:]
                assert tuple(spec) == want, (k, fsdp, tp, spec, want)
                assert spec == specs.param_spec(mesh, k, pl[k].shape, fsdp,
                                                tp)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax_on_decode_32k(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    cap = cfg.meta_tokens + 32_768
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 128, cap))
    pcache = _abstract_cache(cfg, 128, cap)
    assert len(pcache) == cfg.n_layers
    jl = _jax_leaves(jcache)
    pspec = _port_leaves(specs.cache_specs(mesh, pcache))
    for k, t in _port_leaves(pcache).items():
        jk = _stacked_key(k)
        j = jl[jk]
        assert tuple(j.shape) == (cfg.n_layers,) + tuple(t.shape), k
        want = tuple(jspecs.cache_spec(mesh, jk, j.shape))
        assert want[0] is None
        assert tuple(pspec[k]) == want[1:], (k, pspec[k], want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_and_activation_rules_equal_jax(mesh_name):
    mesh = MESHES[mesh_name]
    shapes = {"tokens": (256, 4096), "labels": (256, 4096),
              "embeds": (32, 16, 64), "odd": (7, 3), "scalar": ()}
    for tp in (True, False):
        jb = jspecs.batch_specs(mesh, {k: jax.ShapeDtypeStruct(s, jnp.int32)
                                       for k, s in shapes.items()}, tp=tp)
        pb = specs.batch_specs(mesh, {k: torch.empty(s, device="meta")
                                      for k, s in shapes.items()}, tp=tp)
        assert {k: tuple(v) for k, v in pb.items()} == \
            {k: tuple(v) for k, v in jb.items()}
        for seq in (True, False):
            jr = jspecs.activation_rules(mesh, seq_shard=seq, tp=tp)
            pr = specs.activation_rules(mesh, seq_shard=seq, tp=tp)
            assert {k: tuple(v) for k, v in pr.items()} == \
                {k: tuple(v) for k, v in jr.items()}
    assert specs.dp_axes(mesh) == jspecs.dp_axes(mesh)


def test_best_spec_first_fit_and_placements():
    mesh = make_production_mesh(multi_pod=True)
    fa = ("pod", "data")
    prefs = [[(1, "model")], [(0, fa)], [(2, fa)]]
    for shape in [(64, 32, 8), (7, 32, 64), (64, 5, 8), (0, 16, 16)]:
        assert tuple(specs.best_spec(mesh, shape, prefs)) == tuple(
            jspecs.best_spec(mesh, shape, prefs))
    assert specs.local_shape(mesh, (64, 32, 8), specs.P(fa, "model", None)) \
        == (2, 2, 8)


def test_activation_constrain_is_identity_without_rules_or_dtensor():
    x = torch.randn(4, 8, 16)
    assert activation.constrain(x, "residual") is x
    mesh = make_production_mesh()
    rules = specs.activation_rules(mesh)
    with activation.activation_sharding(mesh, rules):
        assert activation.constrain(x, "residual") is x      # plain tensor
        assert activation.constrain(x, "unknown") is x
        assert activation.dp_group_count() == 16
        assert activation.axis_size("model") == 16
        assert activation.current_rules() is rules
    assert activation.current_mesh() is None
    assert activation.dp_group_count() == 1 and activation.axis_size("x") == 1
    with activation.activation_sharding(make_production_mesh(
            multi_pod=True), {}):
        assert activation.dp_group_count() == 32
    # the JAX rule: drop axes past the rank and those that do not divide
    assert tuple(activation.fit_spec(mesh, specs.P(("data",), "model", None),
                                     (8, 32))) == (None, "model")


# ---------------------------------------------------------------------------
# q-chunked plain attention
# ---------------------------------------------------------------------------
def _attn_inputs(b, sq, sk, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window,softcap,sink", [(0, 0.0, 0), (24, 0.0, 0),
                                                 (16, 30.0, 4)])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
def test_chunked_plain_attention_matches_jax_sdpa_chunked(h, kv, window,
                                                          softcap, sink):
    b, s, dh, chunk = 2, 40, 16, 8
    q, k, v = _attn_inputs(b, s, s, h, kv, dh, seed=h + kv + window)
    pos = np.arange(s, dtype=np.int32)
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    tp = torch.from_numpy(pos)
    got = ref.flash_attention_chunked_ref(
        *tq, tp, tp, window=window, softcap=softcap, sink=sink,
        threshold=16, chunk_q=chunk)
    jk = jnp.repeat(jnp.asarray(k), h // kv, axis=2)
    jv = jnp.repeat(jnp.asarray(v), h // kv, axis=2)
    want = jattn._sdpa_chunked(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                               jnp.asarray(pos), window=window,
                               softcap=softcap, sink=sink, chunk_q=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    full = ref.flash_attention_ref(*tq, tp, tp, window=window,
                                   softcap=softcap, sink=sink)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_plain_attention_is_the_oracle_below_the_threshold(dtype):
    assert ref.CHUNKED_Q_THRESHOLD == jattn.CHUNKED_Q_THRESHOLD == 8192
    assert ref.CHUNK_Q == jattn.CHUNK_Q == 512
    q, k, v = _attn_inputs(1, 33, 33, 4, 2, 16, seed=9)
    tq = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    pos = torch.arange(33, dtype=torch.int32)
    got = ref.flash_attention_chunked_ref(*tq, pos, pos, window=8)
    want = ref.flash_attention_ref(*tq, pos, pos, window=8)
    assert got.dtype == dtype and torch.equal(got, want)
    # at the threshold the chunked form starts (JAX: sq >= threshold)
    got = ref.flash_attention_chunked_ref(*tq, pos, pos, threshold=33,
                                          chunk_q=16)
    want = ref.flash_attention_ref(*tq, pos, pos)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=1e-5 if dtype == torch.float32 else 1e-2,
                               atol=1e-6 if dtype == torch.float32 else 1e-2)


def test_attention_plain_route_takes_the_chunked_form():
    from repro_torch.models.attention import sdpa
    q, k, v = _attn_inputs(1, 20, 20, 2, 1, 16, seed=3)
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    pos = torch.arange(20, dtype=torch.int32)
    got = sdpa(*tq, pos, pos, use_kernel="ref")
    assert torch.equal(got, ref.flash_attention_chunked_ref(*tq, pos, pos))
    assert torch.equal(sdpa(*tq, pos, pos), ref.flash_attention_ref(
        *tq, pos, pos))


# ---------------------------------------------------------------------------
# MoE data-parallel groups
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_apply_with_four_groups_matches_jax(monkeypatch, top_k, cf):
    b, s, d, f, e = 8, 6, 16, 24, 4
    rng = np.random.default_rng(top_k + int(cf * 4))
    p = {"router": (rng.standard_normal((d, e)) * d ** -0.5).astype(
        np.float32),
         "experts": {k: (rng.standard_normal(sh) * sh[1] ** -0.5).astype(
             np.float32) for k, sh in (("w_up", (e, d, f)),
                                       ("w_gate", (e, d, f)),
                                       ("w_down", (e, f, d)))}}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x[3, 2] = 0.0
    monkeypatch.setattr(jmoe, "dp_group_count", lambda: 4)
    jp = jax.tree.map(jnp.asarray, p)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=top_k,
                                act="swiglu", capacity_factor=cf)
    tp = jax.tree.map(torch.from_numpy, p)
    with activation.activation_sharding(AbstractMesh(("data", "model"),
                                                     (4, 1)), {}):
        assert activation.dp_group_count() == 4
        out, aux = moe.moe_apply(tp, torch.from_numpy(x), top_k=top_k,
                                 act="swiglu", capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the groups' capacity differs from one group's: a real change
    one, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=top_k,
                           act="swiglu", capacity_factor=cf)
    assert not torch.equal(one, out)


def test_moe_groups_fall_back_to_one_when_they_do_not_divide_the_batch():
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, 16, 24, 4, "swiglu", torch.float32)
    x = torch.randn(3, 5, 16, generator=g)
    want = moe.moe_apply(p, x, top_k=2, act="swiglu")
    with activation.activation_sharding(AbstractMesh(("data", "model"),
                                                     (2, 1)), {}):
        got = moe.moe_apply(p, x, top_k=2, act="swiglu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
