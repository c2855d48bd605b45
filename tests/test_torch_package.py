"""Package rules of the port: no JAX and no JAX package inside it, the card
by default (and a loud failure without one), and the kernel build's
bookkeeping."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.convert import trace_from_arrays
from repro_torch.core import (latency_improvement, make_hier_trace,
                              make_trace, simulate, simulate_chunked,
                              simulate_hier, simulate_hier_chunked,
                              simulate_stream, stream_of_trace, sweep_grid,
                              sweep_hier_grid, trace_of_stream)
from repro_torch.core.simulator import resolve_score_mode
from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_pulls_in_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
        "repro_torch.kernels.ref, repro_torch.kernels._build, "
        "repro_torch.convert, repro_torch.data.traces, "
        "repro_torch.core.prng, repro_torch.configs.registry, "
        "repro_torch.models.transformer, repro_torch.models.attention, "
        "repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.decode_attention, "
        "repro_torch.kernels.gla_chunk, repro_torch.models.ssm, "
        "repro_torch.profile_serve, repro_torch.profile_replay, "
        "repro_torch.training.train_loop, repro_torch.serving.scheduler, "
        "repro_torch.launch.serve, repro_torch.core.sweep, "
        "repro_torch.core.trace, repro_torch.figures.common, "
        "repro_torch.figures.fig2_synthetic, "
        "repro_torch.figures.fig3_trace_stats, "
        "repro_torch.figures.fig4_sensitivity, "
        "repro_torch.figures.fig5_real_traces, repro_torch.figures.run, "
        "repro_torch.figures.fig6_hierarchy, repro_torch.core.hierarchy, "
        "repro_torch.core.refsim, repro_torch.core.state, "
        "repro_torch.core.percentile, repro_torch.data.scenarios, "
        "repro_torch.serving.faults, repro_torch.serving.engine, "
        "repro_torch.figures.bench_serving, repro_torch.launch.mesh, "
        "repro_torch.launch.fabric, repro_torch.figures.bench_kernels, "
        "repro_torch.figures.bench_sweep, repro_torch.figures.probe_memory, "
        "repro_torch.models.moe, repro_torch.data.tokens, "
        "repro_torch.training.optimizer, repro_torch.training.compression, "
        "repro_torch.training.checkpoint, repro_torch.training.trainer, "
        "repro_torch.launch.train, repro_torch.sharding.specs, "
        "repro_torch.sharding.activation, repro_torch.launch.cells, "
        "repro_torch.launch.dryrun, repro_torch.launch.roofline, "
        "repro_torch.kernels.ops, repro_torch.examples, "
        "repro_torch.examples.quickstart, repro_torch.examples.trace_sim, "
        "repro_torch.examples.hierarchy_sim, "
        "repro_torch.examples.serve_engine, "
        "repro_torch.examples.train_small\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PKG.rglob("*.py"),
                                         ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax_and_no_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path} imports {n}"


def test_source_rule_covers_the_serving_slice():
    paths = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    for mod in ("core/percentile.py", "data/scenarios.py",
                "serving/faults.py", "serving/engine.py",
                "figures/bench_serving.py"):
        assert f"src/repro_torch/{mod}" in paths


def test_source_rule_covers_the_fabric_slice():
    paths = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    for mod in ("launch/mesh.py", "launch/fabric.py",
                "figures/bench_kernels.py", "figures/bench_sweep.py",
                "figures/probe_memory.py"):
        assert f"src/repro_torch/{mod}" in paths


def test_source_rule_covers_the_moe_and_training_slice():
    paths = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    for mod in ("models/moe.py", "data/tokens.py", "training/optimizer.py",
                "training/compression.py", "training/checkpoint.py",
                "training/trainer.py", "training/train_loop.py",
                "launch/train.py"):
        assert f"src/repro_torch/{mod}" in paths


def _cpu_trace():
    return trace_from_arrays([1.0, 2.0], [0, 1], [1.0, 1.0], [0.5, 0.5],
                             [0.5, 0.5], device="cpu")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        simulate(_cpu_trace(), 1.0, "lru")
    with pytest.raises(RuntimeError):
        latency_improvement(_cpu_trace(), 1.0, "stoch_vacdh")
    with pytest.raises(RuntimeError):
        make_trace([1.0], [0], [1.0], [0.5])
    with pytest.raises(RuntimeError):
        trace_from_arrays([1.0], [0], [1.0], [0.5], [0.5])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_grid(_cpu_trace(), 1.0, ["lru", "stoch_vacdh"])
    stream = stream_of_trace(_cpu_trace())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_stream(stream, 1.0, "lru")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_chunked(_cpu_trace(), 1.0, "lru")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_of_stream(stream)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_stream(stream, 1.0, "lru", state_mode="slots")
    hier = make_hier_trace(_cpu_trace(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_hier(hier, 2, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_hier_chunked(hier, 2, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_hier_grid(hier, 2, 1.0, 1.0, ["lru", "stoch_vacdh"])
    from repro_torch.figures import bench_serving
    from repro_torch.serving.engine import DelayedHitPrefixCache, ServeEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(capacity=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DelayedHitPrefixCache(1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_serving.run(smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_serving.main(["--smoke"])
    from repro_torch.figures import bench_kernels, bench_sweep, probe_memory
    from repro_torch.launch.mesh import make_data_mesh, make_local_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_grid(_cpu_trace(), 1.0, "lru", devices=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_hier_grid(hier, 2, 1.0, 1.0, "lru", devices=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_grid(_cpu_trace(), 1.0, "lru",
                   mesh=make_data_mesh(devices=["cuda:0"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh()
    for fn in (bench_kernels.run, lambda: bench_sweep.run(smoke=True),
               probe_memory.run_simstate_probe):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_figure_drivers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    from repro_torch.figures import (fig2_synthetic, fig3_trace_stats,
                                     fig4_sensitivity, fig5_real_traces,
                                     fig6_hierarchy, run)
    for fn in (lambda: fig2_synthetic.run(n_requests=10),
               lambda: fig6_hierarchy.run(n_requests=10),
               fig3_trace_stats.run,
               lambda: fig4_sensitivity.run(n_requests=10),
               lambda: fig4_sensitivity.run_compare(n_requests=10),
               lambda: fig5_real_traces.run(n_requests=10),
               lambda: run.main(["--only", "fig3"]),
               lambda: run.main(["--only", "serving", "--smoke"]),
               lambda: run.main(["--only", "kernels,sweep,memory"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_lm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    from repro_torch.configs import registry
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    cfg = registry.smoke("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build("stablelm-1.6b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_arrays({"layers": {}}, cfg)
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.launch import train
    from repro_torch.training.train_loop import TrainConfig
    from repro_torch.training.trainer import RunConfig, Trainer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build("phi3.5-moe-42b-a6.6b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_at(DataConfig(vocab=8, seq_len=4, global_batch=1), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig(), DataConfig(vocab=8, seq_len=4,
                                               global_batch=1), RunConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke"])


def test_explicit_cpu_runs():
    assert resolve_device("cpu").type == "cpu"
    r = simulate(_cpu_trace(), 1.0, "lru", device="cpu")
    assert int(r.n_misses) == 2 and float(r.total_latency) == 1.0
    with pytest.raises(ValueError, match="unknown policy"):
        simulate(_cpu_trace(), 1.0, "nope", device="cpu")
    from repro_torch.serving.engine import LatencyModel, ServeEngine
    eng = ServeEngine(capacity=1.0, policy="stoch_vacdh", device="cpu",
                      latency=LatencyModel(base_s=1.0, per_token_s=0.0,
                                           stochastic=False),
                      state_size_fn=lambda n: 1.0, hedging=False)
    assert eng.cache.dev.type == "cpu" and eng.cache.mode == "ref"
    assert eng.cache.mirror_f.device.type == "cpu"
    assert [eng.serve(t, "p", 8) for t in (0.0, 0.5, 2.0)] == [
        ("miss", 1.0), ("delayed", 0.5), ("hit", 0.0)]
    assert eng.cache.counters["admits"] == eng.cache.counters["syncs"] == 1


def test_score_mode_resolution():
    assert resolve_score_mode(None, "cpu") == "ref"
    assert resolve_score_mode(None, "cuda") == "kernel"
    assert resolve_score_mode(True, "cpu") == "kernel"
    assert resolve_score_mode(False, "cuda") == "rank"
    assert resolve_score_mode("ref", "cuda") == "ref"
    with pytest.raises(ValueError):
        resolve_score_mode("interpret", "cpu")


def test_build_library_name_tracks_source_and_flags():
    names = {_build.lib_path(n).name for n in _build.SIGNATURES}
    assert len(names) == len(_build.SIGNATURES)
    for n in _build.SIGNATURES:
        assert (_build.CSRC / f"{n}.cu").is_file()
        assert _build.lib_path(n).parent == _build.BUILD_DIR
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_kernel_build_dir_is_ignored_by_git():
    r = subprocess.run(["git", "check-ignore", "-q",
                        str(_build.BUILD_DIR / "libx.so")], cwd=ROOT,
                       timeout=60)
    assert r.returncode == 0


def test_build_raises_without_nvcc(monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_check_raises_on_cuda_error():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "launch")


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=_env(), capture_output=True, text=True,
                       timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(alone)], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_obj_stats_conversion():
    from repro_torch.convert import obj_stats_from_arrays
    n = 3
    f = {k: np.zeros(n, np.float32) for k in (
        "complete_t", "issue_t", "last_access", "first_access", "gap_mean",
        "count", "z_est", "agg_sum", "agg_sq_sum", "agg_cnt",
        "episode_delay", "gd_h")}
    o = obj_stats_from_arrays(device="cpu", cached=np.ones(n, bool),
                              in_flight=np.zeros(n, bool), **f)
    assert o.cached.dtype == torch.bool and o.count.dtype == torch.float32
    with pytest.raises(ValueError, match="missing"):
        obj_stats_from_arrays(device="cpu", cached=np.ones(n, bool))


def test_profile_serve_names_every_lm_kernel():
    """profile_serve's "port kernels" time sums every CUDA kernel of the LM
    path, by exact function name."""
    import re
    from repro_torch.profile_serve import KERNELS, is_port_kernel
    found = set()
    for src in ("flash_attention", "decode_attention", "gla_chunk"):
        text = (_build.CSRC / f"{src}.cu").read_text()
        found |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"(\w+)\s*\(", text))
    assert found == set(KERNELS)
    assert is_port_kernel("void (anonymous namespace)::flash_mma_kernel<64>"
                          "(__nv_bfloat16 const*)")
    assert not is_port_kernel("void at::native::vectorized_elementwise_"
                              "kernel<4>(int)")
