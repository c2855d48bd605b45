"""The GLA family's launch cells as DTensors, bit for bit against plain
tensors, on the CPU.

xLSTM-350M (``ssm``) and Hymba-1.5B (``hybrid``) at smoke size: each of
train_4k, prefill_32k and decode_32k through ``launch.cells.input_specs``
on ``make_local_mesh`` as DTensors over a one-rank gloo ``DeviceMesh``,
against the same steps on plain tensors (``make_train_step`` /
``make_serve_steps``) from the same seed: two train steps (losses and
every parameter and optimizer leaf after them), a prefill (last-token
logits and every cache leaf: the ring, the GLA state, the conv tail), three
decode steps that carry the returned cache (logits and every cache leaf).
The cells' sequences are cut (``SEQ``) so that the CPU runs them in
seconds; each is past the smoke window (32) plus the meta tokens (8) and
is not a multiple of the smoke GLA chunk (16).  A process group is
process-global, so every cell runs in one subprocess.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("xlstm-350m", "hymba-1.5b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SEQ = {"train_4k": 45, "prefill_32k": 77, "decode_32k": 70}
BATCH = 2
DECODE_STEPS = 3

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import device_mesh, make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _slot
    from repro_torch.training.optimizer import (OptConfig, init_opt,
                                                tree_leaves, tree_map)
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_serve_steps,
                                                 make_train_step)

    pg_file, archs, seq, b, n_dec = (sys.argv[1], json.loads(sys.argv[2]),
                                     json.loads(sys.argv[3]),
                                     int(sys.argv[4]), int(sys.argv[5]))
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

    def train(cfg, s):
        tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=2))
        cell = cells.input_specs(cfg, "train_4k", dm, tcfg, global_batch=b)
        g = torch.Generator().manual_seed(6)
        toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=g,
                             dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
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

    def prefill(cfg, s):
        cell = cells.input_specs(cfg, "prefill_32k", dm, global_batch=1)
        toks = torch.randint(0, cfg.vocab, (1, s), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(7))
        p = params(cfg)
        got = cell.fn(*cells.materialize(cell, (
            p, tf.init_cache(cfg, 1, cfg.meta_tokens + s + 1, "cpu"),
            {"tokens": toks})))
        want = make_serve_steps(cfg)[0](
            p, tf.init_cache(cfg, 1, cfg.meta_tokens + s + 1, "cpu"),
            {"tokens": toks})
        return dict(equal=same(got, want),
                    finite=bool(torch.isfinite(local(got[0])).all()))

    def filled_cache(cfg, first, g):
        # the state before position ``first``: the ring's last slots and
        # the sink, a GLA state and a conv tail, from a seed
        cache = tf.init_cache(cfg, b, cfg.meta_tokens + seq["decode_32k"],
                              "cpu")
        for c in cache:
            if "attn" in c:
                a, sink = c["attn"], cfg.meta_tokens
                ring = a["k"].shape[1] - sink
                pos = torch.cat([torch.arange(min(sink, first)),
                                 torch.arange(max(sink, first - ring),
                                              first)]).to(torch.int32)
                a["k"].normal_(generator=g)
                a["v"].normal_(generator=g)
                a["kpos"][_slot(pos.long(), sink, ring)] = pos
            if "ssm" in c:
                for k in ("S", "n", "conv"):
                    c["ssm"][k].normal_(generator=g)
        return cache

    def decode(cfg, s):
        cell = cells.input_specs(cfg, "decode_32k", dm, global_batch=b)
        first = cfg.meta_tokens + s - n_dec
        g = torch.Generator().manual_seed(8)
        toks = torch.randint(0, cfg.vocab, (n_dec, b, 1), generator=g,
                             dtype=torch.int32)
        p = params(cfg)
        out = {}
        for label in ("dtensor", "plain"):
            cache = filled_cache(cfg, first, torch.Generator().manual_seed(9))
            logits = []
            for i in range(n_dec):
                pos = torch.tensor(first + i, dtype=torch.int32)
                if label == "dtensor":
                    lg, cache = cell.fn(*cells.materialize(
                        cell, (p, cache, toks[i], pos)))
                    cache = tree_map(local, cache)
                else:
                    lg, cache = make_serve_steps(cfg)[1](
                        p, cache, tokens=toks[i], pos0=pos)
                logits.append(local(lg))
            out[label] = (logits, cache)
        d, q = out["dtensor"], out["plain"]
        return dict(equal=same(d, q),
                    finite=all(bool(torch.isfinite(x).all()) for x in d[0]))

    run = {"train_4k": train, "prefill_32k": prefill, "decode_32k": decode}
    for arch in archs:
        cfg = registry.smoke(arch)
        for shape, fn in run.items():
            rec = fn(cfg, seq[shape])
            rec.update(arch=arch, shape=shape)
            print(json.dumps(rec), flush=True)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    pg = tmp_path_factory.mktemp("pg") / "pg"
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(pg), json.dumps(ARCHS),
         json.dumps(SEQ), str(BATCH), str(DECODE_STEPS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    recs = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]
    return {(x["arch"], x["shape"]): x for x in recs}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gla_cell_as_dtensors_equals_plain_tensors(results, arch, shape):
    rec = results[(arch, shape)]
    assert rec["finite"], rec
    assert rec["equal"], rec
    if shape == "train_4k":
        assert rec["losses"][1] < rec["losses"][0], rec
