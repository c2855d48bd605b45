"""A whole run on the CPU (the harness's look for a card skipped) at tiny
sizes under each cell's own limits: sound, it is correct; with the timed
path broken underneath, ``correct`` comes out false, once for each fault
the cell can have (one chip: no exchange between chips to leave out).
The control, the reference in float8 in the program's place, fails too.
"""
import copy

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.entries import prefill, train
from perfbench.tests import tiny

PREFILL_CELLS = {"starcoder2-15b.prefill_code16k": tiny.STARCODER,
                 "deepseek-coder-33b.prefill_code16k": tiny.DEEPSEEK}
TRAIN_CELLS = {"deepseek-coder-33b.train_4k": tiny.DEEPSEEK,
               "starcoder2-15b.train_4k": tiny.STARCODER}
BIG_SEED = 2 ** 31 + 977


def _run(workload, fam, entry_cls=None, trace=False):
    c = tiny.cell(workload, **fam)
    return harness.run_cell(c, BIG_SEED, 0.3, trace, "cpu",
                            entry_cls=entry_cls)


# -- prefill faults -------------------------------------------------------
class Unchanged(prefill.Entry):
    """The prefill leaves the cache as it found it."""

    def make_step(self):
        step = super().make_step()

        def run(params, cache, batch):
            logits, _ = step(params, copy.deepcopy(cache), batch)
            return logits, cache
        return run


class HalfPrompt(prefill.Entry):
    """Half of the prompt left out."""

    def make_step(self):
        step = super().make_step()
        return lambda p, c, b: step(p, c, {"tokens": b["tokens"][
            :, b["tokens"].shape[1] // 2:]})


class AlteredAnswer(prefill.Entry):
    """The answer altered where it is produced: each logit moved to the
    next token id, so the first token read is another one."""

    def make_step(self):
        step = super().make_step()

        def run(params, cache, batch):
            logits, cache = step(params, cache, batch)
            return logits.roll(1, dims=-1), cache
        return run


# -- train faults ---------------------------------------------------------
class UnchangedState(train.Entry):
    """The step returns its weights and optimizer state unchanged."""

    def make_step(self):
        step = super().make_step()

        def run(params, opt, batch):
            _, _, m = step(copy.deepcopy(params), copy.deepcopy(opt), batch)
            return params, opt, m
        return run


# half of the batch left out, the mean taken over the rest; the loss
# altered where it is produced (as calibrate.py reads them on the card)
HalfBatch = calibrate.fault(train.Entry, "fault_half_batch")
AlteredLoss = calibrate.fault(train.Entry, "fault_altered_loss")


@pytest.mark.parametrize("workload", list(PREFILL_CELLS))
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_prefill_sound_run_is_correct(workload, trace):
    res, checks = _run(workload, PREFILL_CELLS[workload], trace=trace)
    assert res["correct"], checks
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", list(TRAIN_CELLS))
def test_train_sound_run_is_correct(workload):
    res, checks = _run(workload, TRAIN_CELLS[workload])
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("workload", list(PREFILL_CELLS))
@pytest.mark.parametrize("fault", [Unchanged, HalfPrompt, AlteredAnswer])
def test_prefill_fault_is_not_correct(workload, fault):
    res, checks = _run(workload, PREFILL_CELLS[workload], fault)
    assert not res["correct"], checks


@pytest.mark.parametrize("workload", list(TRAIN_CELLS))
@pytest.mark.parametrize("fault", [UnchangedState, HalfBatch, AlteredLoss])
def test_train_fault_is_not_correct(workload, fault):
    res, checks = _run(workload, TRAIN_CELLS[workload], fault)
    assert not res["correct"], checks


@pytest.mark.parametrize("workload", list(PREFILL_CELLS))
def test_prefill_control_fails(workload):
    c = tiny.cell(workload, **PREFILL_CELLS[workload])
    e = prefill.Entry(c, BIG_SEED, torch.device("cpu"))
    e.setup()
    e.window(0.2, harness._no_span)
    e.release()
    ctl = prefill.control_outputs(e, [(i, s) for i, s, _ in e.sample])
    ok, checks = harness.judge(prefill.compare(e, *ctl), c.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", list(TRAIN_CELLS))
def test_train_control_fails(workload):
    c = tiny.cell(workload, **TRAIN_CELLS[workload])
    e = train.Entry(c, BIG_SEED, torch.device("cpu"))
    ok, checks = harness.judge(
        train.compare(train.reference_readings(e, "fp8"),
                      train.reference_readings(e, None)), c.limits)
    assert not ok, checks


@pytest.mark.parametrize("lengths,want", [
    ([64, 16, 32, 64, 16, 32], [(5, 32), (3, 64)]),   # the last, a longest
    ([16, 64, 32, 16, 64, 32], [(5, 32), (4, 64)]),
])
def test_the_check_judges_the_last_and_a_longest_request(lengths, want):
    e = prefill.Entry(tiny.cell("starcoder2-15b.prefill_code16k",
                                **tiny.STARCODER), BIG_SEED,
                      torch.device("cpu"))
    e.done = [(i, s, None) for i, s in enumerate(lengths)]
    assert [(i, s) for i, s, _ in e.picked()] == want


def test_a_longest_last_request_is_judged_with_another_length():
    e = prefill.Entry(tiny.cell("starcoder2-15b.prefill_code16k",
                                **tiny.STARCODER), BIG_SEED,
                      torch.device("cpu"))
    e.done = [(i, s, None) for i, s in enumerate([16, 32, 64, 16, 32, 64])]
    last, other = e.picked()
    assert last[:2] == (5, 64) and other[1] != 64
