"""The harness finds every file by the names in ``BENCHMARK.json``; a
configuration, a traffic mix and a per-layer metric are added as new
files and entries, with no edit to a file that is there; and
``BENCHMARK.json`` keeps to the benchmark's format."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness, yardstick
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj\w*|head)_size$"
                    r"|_dim$|_rank$|expan|experts_per_tok")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = harness.load_cell(workload, ROOT)
    w = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.config["name"] == w["config"]
    assert harness.entry_module(cell).Entry
    assert yardstick.family(cell.config).Model
    assert set(cell.limits["checks"])
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for name in cell.per_layer:
        assert callable(harness.metric_reader(name))
    harness.port_config(cell.config)        # the program runs this model


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key), key
        names.add(c["name"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]].get("workloads")
        assert moved is None or set(m["workloads"]) <= set(moved)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH, indent=1)) < 64 * 1024


NEW_CONFIG = dict(tiny.config(**tiny.STARCODER), name="tiny-coder",
                  reduced=[])
NEW_TRAFFIC = {"entry": "prefill", "capacity": 32,
               "lengths": {"levels": [[9, 16], [17, 32]], "per_level": 2,
                           "mix_seed": 5}}
NEW_METRIC = '''"""requests.prefill (requests): the requests the window finished."""


def read(ctx):
    lengths = ctx.work.get("prefill_lengths")
    return float(len(lengths)) if lengths else None
'''

DRIVE = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from perfbench import harness, yardstick
cell = harness.load_cell("tiny-coder.prefill_tiny", sys.argv[1])
res, _ = harness.run_cell(cell, 2 ** 31 + 5, 0.2, True, "cpu")
print(json.dumps({"per_layer": cell.per_layer, "result": res}))
"""


def test_a_cell_is_added_as_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell's limits as new files, and entries in
    BENCHMARK.json; no file already there is edited, and the new cell
    runs with its new metric (on the CPU, at a tiny size)."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "perfbench"
    (pb / "configs" / "tiny-coder.json").write_text(json.dumps(NEW_CONFIG))
    (pb / "traffic" / "prefill_tiny.json").write_text(json.dumps(NEW_TRAFFIC))
    (pb / "metrics" / "requests.prefill.py").write_text(NEW_METRIC)
    shutil.copy(pb / "limits" / "starcoder2-15b.prefill_code16k.json",
                pb / "limits" / "tiny-coder.prefill_tiny.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-coder", "source": "test",
                             "file": "perfbench/configs/tiny-coder.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-coder.prefill_tiny",
                               "config": "tiny-coder",
                               "traffic": "prefill_tiny", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "prefill_tok_s":
            m["workloads"].append("tiny-coder.prefill_tiny")
    bench["per_layer"].append({"name": "requests.prefill",
                               "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "step",
                               "moves": "prefill_tok_s",
                               "workloads": ["tiny-coder.prefill_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", DRIVE, str(tmp_path),
                          str(ROOT / "src")], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert "requests.prefill" in got["per_layer"]
    assert got["result"]["correct"]
    assert got["result"]["metrics"]["requests.prefill"]["value"] == \
        got["result"]["attempted"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_prefill_mix_is_one_set_of_lengths_in_an_order_of_the_seed():
    """The traffic file's lengths: one in each of its levels, none a
    multiple of a 64-position tile, within the cache; every seed serves
    the same lengths, in an order of its own."""
    from perfbench.entries import prefill
    t = json.loads((ROOT / "perfbench/traffic/prefill_code16k.json")
                   .read_text())
    mix = prefill.mix(t)
    levels = t["lengths"]["levels"]
    assert len(mix) == len(levels) * t["lengths"]["per_level"]
    for s, (lo, hi) in zip(mix, levels):
        assert lo <= s <= hi <= t["capacity"] and s % 64
    orders = [prefill.cycle(t, 2 ** 31 + n) for n in range(6)]
    assert all(sorted(o) == sorted(mix) for o in orders)
    assert len({tuple(o) for o in orders}) > 1
    assert prefill.cycle(t, 2 ** 31 + 3) == orders[3]


NEW_FAMILY = dict(
    tiny.config(registry="phi3.5-moe-42b-a6.6b", window=None, mlp="swiglu"),
    name="tiny-moe", reference="moe", reduced=[], num_local_experts=4,
    num_experts_per_tok=2)
NEW_FAMILY["as_run"] = dict(
    NEW_FAMILY["as_run"], capacity_factor=1.25,
    port_fields=dict(NEW_FAMILY["as_run"]["port_fields"], n_experts=4,
                     top_k=2, capacity_factor=1.25, rope_theta=100000.0))

DRIVE_FAMILY = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from perfbench import harness, yardstick
cell = harness.load_cell("tiny-moe.prefill_tiny", sys.argv[1])
res, checks = harness.run_cell(cell, 2 ** 31 + 7, 0.2, False, "cpu")
print(json.dumps({"result": res, "checks": checks,
                  "geometry": yardstick.geometry(cell.config)}))
"""


def test_a_family_is_added_as_files_and_entries(tmp_path):
    """A copy of the benchmark gains a model family (``reference/moe.py``:
    its weight tree, counts, program fields and equations), a
    configuration of it, a traffic mix and a cell's limits as new files,
    and entries in BENCHMARK.json; no file already there is edited.  The
    new cell runs on the CPU at a tiny size in float32 through the
    program's MoE blocks, capacity drops included, and its reference
    follows the program to float32 rounding."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    shutil.copy(pb / "tests" / "new_family" / "moe.py",
                pb / "reference" / "moe.py")
    (pb / "configs" / "tiny-moe.json").write_text(json.dumps(NEW_FAMILY))
    (pb / "traffic" / "prefill_tiny.json").write_text(json.dumps(
        {"entry": "prefill", "capacity": 80,
         "lengths": {"levels": [[16, 16], [80, 80], [48, 48]],
                     "per_level": 1, "mix_seed": 1}}))
    shutil.copy(pb / "limits" / "deepseek-coder-33b.prefill_code16k.json",
                pb / "limits" / "tiny-moe.prefill_tiny.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "perfbench/configs/tiny-moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-moe.prefill_tiny",
                               "config": "tiny-moe",
                               "traffic": "prefill_tiny", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "prefill_tok_s" in (m["name"], m.get("moves")):
            m["workloads"].append("tiny-moe.prefill_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", DRIVE_FAMILY, str(tmp_path),
                          str(ROOT / "src")], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["result"]["correct"], got["checks"]
    assert got["checks"]["logits_err"]["value"] < 1e-5
    assert got["checks"]["cache_err"]["value"] < 1e-5
    # attention 2 x 64 x 64 + 2 x 64 x 32; two gated experts of 3 x 64 x
    # 128 a token; the router 64 x 4
    assert got["geometry"]["matrix_params"] == 12288 + 2 * 24576 + 256
    after = {p: p.read_bytes() for p in before}
    assert after == before
