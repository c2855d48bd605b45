"""The launch cells of the embeds-fed and MoE families as DTensors, bit for
bit against plain tensors, on the CPU.

LLaVA-NeXT-Mistral-7B (``vlm``) and MusicGen-large (``audio``) take
frontend embeddings (``embeds``, (B, S, d)) where the other families take
token ids; MusicGen's logits are (B, S, 4, V), one row of V a codebook.
phi3.5-MoE and Grok-1 (``moe``; Grok-1 with its attention softcap of 30)
route every token to its top 2 experts, and on DTensors that routing, the
capacity dispatch's scatter-add and its gather run shard by shard.  At
smoke size each of train_4k, prefill_32k and decode_32k runs through
``launch.cells.input_specs`` on ``make_local_mesh`` as DTensors over a
one-rank gloo ``DeviceMesh``, against the same steps on plain tensors
(``make_train_step`` / ``make_serve_steps``) from the same seed: two train
steps (losses and every parameter and optimizer leaf after them), a
prefill (last-token logits and every cache leaf), three decode steps that
carry the returned cache (logits and every cache leaf).  The train batch
is ``data.tokens.batch_at`` with the config's frontend, as the trainer
makes it.  The sequences are cut (``SEQ``) so that the CPU runs them in
seconds.  A process group is process-global, so every cell runs in one
subprocess.

MusicGen's four-head loss through the port's plain train step is also held
against the JAX ``loss_fn`` on the same embeds and converted weights, in
f32, at ``rtol=1e-5``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("llava-next-mistral-7b", "musicgen-large", "phi3.5-moe-42b-a6.6b",
         "grok-1-314b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SEQ = {"train_4k": 45, "prefill_32k": 77, "decode_32k": 70}
BATCH = 2
DECODE_STEPS = 3

# Runs ``archs`` x ``shapes`` on a one-rank gloo mesh and prints one JSON
# record a cell: ``equal`` (DTensors == plain tensors, bit for bit) and
# ``finite``.  ``seq`` cuts each named shape's sequence; a shape it does not
# name keeps its length.  A decode shape's cache is filled from a seed as it
# stands before its last ``n_dec`` positions.  ``kv_dtype`` is every
# config's KV-cache dtype ("bf16", or "f8": fp8 e4m3).
SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import device_mesh, make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _slot
    from repro_torch.training.optimizer import (OptConfig, init_opt,
                                                tree_leaves, tree_map)
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_serve_steps,
                                                 make_train_step)

    (pg_file, archs, shapes, seq, b, n_dec, kv_dtype) = (
        sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]),
        json.loads(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6]),
        sys.argv[7])
    for name, n in seq.items():
        SHAPES[name] = dataclasses.replace(SHAPES[name], seq_len=n)
    dist.init_process_group("gloo", init_method="file://" + pg_file,
                            rank=0, world_size=1)
    dm = device_mesh(make_local_mesh(device="cpu"))

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    def same(a, b):
        a, b = [local(x) for x in tree_leaves(a)], tree_leaves(b)
        return len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    def params(cfg):
        return tf.init_params(torch.Generator().manual_seed(5), cfg)

    def inputs(cfg, shape, g):
        # token ids, or the frontend's embeddings in the model's dtype
        if cfg.frontend == "none":
            return torch.randint(0, cfg.vocab, shape, generator=g,
                                 dtype=torch.int32)
        return (torch.randn((*shape, cfg.d_model), generator=g) * 0.02).to(
            cfg.torch_dtype)

    def key(cfg):
        return "tokens" if cfg.frontend == "none" else "embeds"

    def train(cfg, shape, s):
        tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=2))
        cell = cells.input_specs(cfg, shape, dm, tcfg, global_batch=b)
        batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=s + 1,
                                    global_batch=b), 0,
                         frontend=cfg.frontend, d_model=cfg.d_model,
                         device="cpu")
        batch = {k: v.to(cfg.torch_dtype if k == "embeds" else torch.int32)
                 for k, v in batch.items()}
        out = {}
        for label in ("dtensor", "plain"):
            p = params(cfg)
            st = (p, init_opt(p), batch)
            if label == "dtensor":
                args, step = cells.materialize(cell, st), cell.fn
            else:
                args, step = st, make_train_step(cfg, tcfg)
            losses = []
            for _ in range(2):
                p, o, m = step(*args)
                args = (p, o, args[2])
                losses.append(float(local(m["loss"])))
            out[label] = (losses, (p, o))
        d, p = out["dtensor"], out["plain"]
        return dict(equal=d[0] == p[0] and same(d[1], p[1]),
                    losses=d[0], plain_losses=p[0],
                    finite=all(l == l for l in d[0]))

    def prefill(cfg, shape, s):
        cell = cells.input_specs(cfg, shape, dm, global_batch=1)
        batch = {key(cfg): inputs(cfg, (1, s),
                                  torch.Generator().manual_seed(7))}
        p = params(cfg)
        got = cell.fn(*cells.materialize(cell, (
            p, tf.init_cache(cfg, 1, cfg.meta_tokens + s + 1, "cpu"),
            batch)))
        want = make_serve_steps(cfg)[0](
            p, tf.init_cache(cfg, 1, cfg.meta_tokens + s + 1, "cpu"), batch)
        return dict(equal=same(got, want),
                    logits_shape=list(local(got[0]).shape),
                    finite=bool(torch.isfinite(local(got[0])).all()))

    def filled_cache(cfg, bb, capacity, first, g):
        # the state before position ``first``: the ring's last slots and
        # the sink, a recurrent state and a conv tail, from a seed
        cache = tf.init_cache(cfg, bb, capacity, "cpu")
        for c in cache:
            if "attn" in c:
                a, sink = c["attn"], cfg.meta_tokens
                ring = a["k"].shape[1] - sink
                pos = torch.cat([torch.arange(min(sink, first)),
                                 torch.arange(max(sink, first - ring),
                                              first)]).to(torch.int32)
                for t in (a["k"], a["v"]):
                    # drawn in the model's dtype: fp8 has no normal_
                    t.copy_(torch.empty_like(t, dtype=cfg.torch_dtype)
                            .normal_(generator=g))
                a["kpos"][_slot(pos.long(), sink, ring)] = pos
            if "ssm" in c:
                for k in ("S", "n", "conv"):
                    c["ssm"][k].normal_(generator=g)
        return cache

    def decode(cfg, shape, s):
        bb = SHAPES[shape].global_batch if shape == "long_500k" else b
        cell = cells.input_specs(cfg, shape, dm, global_batch=bb)
        first = cfg.meta_tokens + s - n_dec
        toks = inputs(cfg, (n_dec, bb, 1), torch.Generator().manual_seed(8))
        p = params(cfg)
        _, step = make_serve_steps(cfg)
        out = {}
        for label in ("dtensor", "plain"):
            cache = filled_cache(cfg, bb, cfg.meta_tokens + s, first,
                                 torch.Generator().manual_seed(9))
            logits = []
            for i in range(n_dec):
                pos = torch.tensor(first + i, dtype=torch.int32)
                if label == "dtensor":
                    lg, cache = cell.fn(*cells.materialize(
                        cell, (p, cache, toks[i], pos)))
                    cache = tree_map(local, cache)
                else:
                    lg, cache = step(p, cache, pos0=pos,
                                     **{key(cfg): toks[i]})
                logits.append(local(lg))
            out[label] = (logits, cache)
        d, q = out["dtensor"], out["plain"]
        return dict(equal=same(d, q), first=first, batch=bb,
                    logits_shape=list(d[0][0].shape),
                    finite=all(bool(torch.isfinite(x).all()) for x in d[0]))

    run = {"train": train, "prefill": prefill, "decode": decode}
    for arch in archs:
        cfg = dataclasses.replace(registry.smoke(arch), kv_dtype=kv_dtype)
        for shape in shapes:
            rec = run[SHAPES[shape].kind](cfg, shape, SHAPES[shape].seq_len)
            rec.update(arch=arch, shape=shape)
            print(json.dumps(rec), flush=True)
    dist.destroy_process_group()
""")


def run_cells(tmp_dir, archs, shapes, seq, batch=BATCH,
              decode_steps=DECODE_STEPS, timeout=600,
              kv_dtype="bf16") -> dict:
    """``SCRIPT`` in a subprocess, the serving caches in ``kv_dtype``:
    {(arch, shape): record}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_dir / "pg"),
         json.dumps(list(archs)), json.dumps(list(shapes)), json.dumps(seq),
         str(batch), str(decode_steps), kv_dtype],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    recs = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]
    return {(x["arch"], x["shape"]): x for x in recs}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cells(tmp_path_factory.mktemp("pg"), ARCHS, SHAPES, SEQ)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_family_cell_as_dtensors_equals_plain_tensors(results, arch, shape):
    rec = results[(arch, shape)]
    assert rec["finite"], rec
    assert rec["equal"], rec
    if shape == "train_4k":
        assert rec["losses"][1] < rec["losses"][0], rec
    if arch == "musicgen-large" and shape != "train_4k":
        assert rec["logits_shape"][-2:] == [4, 256], rec   # 4 codebooks


def test_musicgen_four_head_loss_equals_jax():
    """The port's plain train step's loss (before its update) on MusicGen's
    four codebook heads against the JAX ``loss_fn`` on the same embeds,
    labels and weights, in f32."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import registry as jregistry
    from repro.models import transformer as jtf
    from repro_torch.configs import registry
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.training.optimizer import init_opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    arch, b, s = "musicgen-large", 2, 23
    jcfg = dataclasses.replace(jregistry.smoke(arch), dtype="float32",
                               use_kernel=True)
    jparams = jtf.init_params(jax.random.key(31), jcfg)
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    rng = np.random.default_rng(31)
    embeds = (rng.standard_normal((b, s, cfg.d_model)) * 0.02).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    want, _ = jtf.loss_fn(jparams, jcfg, {"embeds": jnp.asarray(embeds),
                                          "labels": jnp.asarray(labels)})
    step = make_train_step(cfg, TrainConfig())
    _, _, m = step(params, init_opt(params),
                   {"embeds": torch.from_numpy(embeds),
                    "labels": torch.from_numpy(labels)})
    assert cfg.out_heads == 4
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-5)


@pytest.mark.parametrize("mesh_shape, want", [
    ((16, 16), ("data", None, None)),     # 4 codebooks over 16: replicated
    ((2, 2), ("data", None, "model")),    # over 2: the codebook axis splits
])
def test_musicgen_logits_rule_shards_the_codebook_axis_as_jax(mesh_shape,
                                                               want):
    """The 3-D ``logits`` rule fitted to MusicGen's (B, S, 4, V) logits:
    cut to the first three dims, as the JAX ``constrain`` cuts it, so the
    TP axis lands on the codebook dim where it divides 4."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding import specs
    from repro_torch.sharding.activation import fit_spec
    mesh = AbstractMesh(("data", "model"), mesh_shape)
    rule = specs.activation_rules(mesh)["logits"]
    assert tuple(fit_spec(mesh, rule, (32, 4096, 4, 2048))) == want
