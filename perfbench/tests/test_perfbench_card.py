"""On the card (the ``card`` marker; these skip without one): each cell's
whole run at a tiny size through the program's kernels, traced, is
correct under the cell's own limits and reads its per-layer metrics
from the device trace; the control, the reference in float8 in the
program's place, is not correct.

    python -m pytest -q -m card perfbench/tests
"""
import pytest

from perfbench import harness
from perfbench.entries import prefill, train
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_faults import (BIG_SEED, PREFILL_CELLS,
                                                   TRAIN_CELLS)

CELLS = {**PREFILL_CELLS, **TRAIN_CELLS}


@pytest.mark.card
@pytest.mark.parametrize("workload", list(CELLS))
def test_tiny_cell_on_the_card(card, workload):
    c = tiny.cell(workload, **CELLS[workload])
    res, checks = harness.run_cell(c, BIG_SEED, 0.5, True, card.type)
    assert res["correct"], checks
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert "flash_attn_roofline." + c.traffic["entry"] in res["metrics"]
    for name, m in res["metrics"].items():
        if name.startswith(("mfu", "flash_attn_roofline", "attn_share",
                            "idle_share")):
            assert 0 < m["value"] <= 100, (name, m)


@pytest.mark.card
@pytest.mark.parametrize("workload", list(CELLS))
def test_tiny_control_on_the_card_is_not_correct(card, workload):
    c = tiny.cell(workload, **CELLS[workload])
    if c.traffic["entry"] == "prefill":
        e = prefill.Entry(c, BIG_SEED, card)
        e.setup()
        e.window(0.2, harness._no_span)
        e.release()
        numbers = prefill.compare(e, *prefill.control_outputs(
            e, [(i, s) for i, s, _ in e.sample]))
    else:
        e = train.Entry(c, BIG_SEED, card)
        numbers = train.compare(train.reference_readings(e, "fp8"),
                                train.reference_readings(e, None))
    ok, checks = harness.judge(numbers, c.limits)
    assert not ok, checks
