"""The port's preemption-safe trainer and its entry point on the CPU
(mirrors of ``tests/test_training.py``): runs, resumes from the latest
checkpoint bit for bit, stops on SIGTERM with a saved state, and its loss
falls."""
import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data.tokens import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.training.optimizer import OptConfig, tree_leaves
from repro_torch.training.train_loop import TrainConfig
from repro_torch.training.trainer import RunConfig, Trainer


def _setup(tmp_path, arch="stablelm-1.6b", steps=6, **run):
    cfg = dataclasses.replace(registry.smoke(arch), remat="none")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=20))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    rcfg = RunConfig(**{"steps": steps, "ckpt_every": 3, "log_every": 3,
                        "ckpt_dir": str(tmp_path), **run})
    return cfg, tcfg, dcfg, rcfg


def test_trainer_runs_and_resumes(tmp_path):
    cfg, tcfg, dcfg, rcfg = _setup(tmp_path)
    t1 = Trainer(cfg, tcfg, dcfg, rcfg, device="cpu", log_fn=lambda s: None)
    out1 = t1.run()
    assert out1["final_step"] == 6 and not out1["preempted"]
    assert all(np.isfinite([h["loss"] for h in out1["history"]]))
    t2 = Trainer(cfg, tcfg, dcfg, dataclasses.replace(rcfg, steps=9),
                 device="cpu", log_fn=lambda s: None)
    assert t2.start_step == 6
    for a, b in zip(tree_leaves(t2.state()), tree_leaves(t1.state())):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert t2.run()["final_step"] == 9


def test_preempted_run_resumes_to_the_uninterrupted_result(tmp_path):
    """SIGTERM after step 3 stops the loop with a blocking save; a new
    trainer resumes there and ends where an uninterrupted run ends, bit
    for bit (the batches are a function of the step)."""
    cfg, tcfg, dcfg, rcfg = _setup(tmp_path / "a", arch="phi3.5-moe-42b-a6.6b",
                                   ckpt_every=2)

    def log(s):
        if s.startswith("[trainer] step 3:"):
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    try:
        t1 = Trainer(cfg, tcfg, dcfg, dataclasses.replace(rcfg, log_every=1),
                     device="cpu", log_fn=log)
        out1 = t1.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out1["preempted"] and out1["final_step"] == 3
    t2 = Trainer(cfg, tcfg, dcfg, rcfg, device="cpu", log_fn=lambda s: None)
    assert t2.start_step == 3
    for a, b in zip(tree_leaves(t2.state()), tree_leaves(t1.state())):
        assert torch.equal(a, b)
    t2.run()
    t3 = Trainer(cfg, tcfg, dcfg, dataclasses.replace(
        rcfg, ckpt_dir=str(tmp_path / "b")), device="cpu",
        log_fn=lambda s: None)
    t3.run()
    for a, b in zip(tree_leaves(t2.state()), tree_leaves(t3.state())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "phi3.5-moe-42b-a6.6b"])
def test_training_loss_decreases_smoke(tmp_path, arch):
    cfg = dataclasses.replace(registry.smoke(arch), remat="none")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5,
                                     total_steps=60))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    rcfg = RunConfig(steps=60, ckpt_every=1000, log_every=5,
                     ckpt_dir=str(tmp_path))
    out = Trainer(cfg, tcfg, dcfg, rcfg, device="cpu",
                  log_fn=lambda s: None).run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    assert last < first - 0.5, (first, last)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "xlstm-350m"])
def test_launch_train_smoke_on_the_cpu(tmp_path, arch, capsys):
    out = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "4", "--seq", "16", "--batch", "4",
                             "--microbatches", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 4 and not out["preempted"]
    assert "[train] done at step 4" in capsys.readouterr().out
    assert (tmp_path / registry.smoke(arch).name / "LATEST").exists()


def test_trainer_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg, tcfg, dcfg, rcfg = _setup(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, tcfg, dcfg, rcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "stablelm-1.6b", "--smoke",
                           "--ckpt-dir", str(tmp_path)])
