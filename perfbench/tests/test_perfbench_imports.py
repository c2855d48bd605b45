"""Nothing the harness, the reference or the program's path that a run
drives loads JAX or the JAX package ``repro``: top-level module names
compared whole (the port, ``repro_torch``, begins with ``repro``)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from perfbench import harness
from perfbench.tests import tiny
for workload, fam in (("starcoder2-15b.prefill_code16k", tiny.STARCODER),
                      ("deepseek-coder-33b.train_4k", tiny.DEEPSEEK)):
    res, _ = harness.run_cell(tiny.cell(workload, **fam), 2 ** 31 + 11, 0.2,
                              True, "cpu")
    assert res["correct"], res
import perfbench.calibrate
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", DRIVE, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch_fake", "jaxlike", "reproduce.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core.fake", object())
    assert harness.forbidden_modules() == ["repro"]


@pytest.mark.parametrize("path", sorted(
    (ROOT / "perfbench").rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    """Each file's imports by top-level name; the reference's also import
    nothing of the program."""
    banned = set(harness.FORBIDDEN)
    if "reference" in path.parts:
        banned |= {"repro_torch"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert not set(tops) & banned, (path, tops)
