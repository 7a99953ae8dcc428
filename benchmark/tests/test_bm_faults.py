"""With the timed path broken underneath, a run's ``correct`` comes out
false: once for each fault its cell can have (``cstbench/faults.py``),
and for the control, the program's bfloat16 path, which a float32 cell's
limits must refuse.  The harness's look for a chip is skipped: the run
is driven through ``session.run`` on the CPU at a tiny size."""

import pytest
import torch

from _tiny import CELLS, tiny_cell

from cstbench import check, faults, session

CASES = [(c, f) for c in CELLS for f in tiny_cell(c).limits["faults"]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    rec = session.run(cell, 424242, 0.2, False, torch.device("cpu"), 0.0,
                      plant=faults.PLANTS[fault])
    assert not check.verdict(rec.numbers, cell.limits["limits"]), \
        rec.numbers


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    rec = session.run(cell, 515151, 0.0, False, torch.device("cpu"), 0.0,
                      options={"use_bfloat16": 1})
    assert not check.verdict(rec.numbers, cell.limits["limits"]), \
        rec.numbers


def test_the_faults_leave_the_program_as_it_was():
    from cst_captioning_tpu_torch.models import captioner, encoder
    from cst_captioning_tpu_torch.training import steps

    def hooks():
        return (steps.rollout, steps.cross_entropy_loss, steps.reward_loss,
                steps.ciderd_scores, encoder.dropout_keep,
                captioner.dropout_keep)

    before = hooks()
    for name in CELLS:
        for fault in faults.PLANTS.values():
            session.run(tiny_cell(name), 7, 0.0, False, torch.device("cpu"),
                        0.0, plant=fault)
    assert hooks() == before
