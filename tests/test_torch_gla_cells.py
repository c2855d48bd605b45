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
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("xlstm-350m", "hymba-1.5b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _family_cells():
    # the cells' script is ``test_torch_family_cells.py``'s
    spec = importlib.util.spec_from_file_location(
        "family_cells", ROOT / "tests" / "test_torch_family_cells.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cells = _family_cells()
    return cells.run_cells(tmp_path_factory.mktemp("pg"), ARCHS, SHAPES,
                           cells.SEQ)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gla_cell_as_dtensors_equals_plain_tensors(results, arch, shape):
    rec = results[(arch, shape)]
    assert rec["finite"], rec
    assert rec["equal"], rec
    if shape == "train_4k":
        assert rec["losses"][1] < rec["losses"][0], rec
