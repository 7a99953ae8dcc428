"""On the card, at each cell's own size: a sound run of the program's
first steps is within the cell's limits, and the control (the program's
bfloat16 path) is not.  Run there with

    python -m pytest -m cuda benchmark/tests/test_bm_cuda.py

Each case decides in its fixture whether a card is present and skips
without one."""

import pytest

from _tiny import CELLS, spec

from cstbench import check


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU "
                    "mode, and the cells' sizes are the card's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_passes_and_control_fails_at_cell_size(card, name):
    import control

    cell = spec.load_cell(name)
    shared: dict = {}
    sound = control.readings(cell, 2_147_483_659, "sound", card, shared)
    low = control.readings(cell, 2_147_483_659, "control", card, shared)
    limits = cell.limits["limits"]
    assert check.verdict(sound["numbers"], limits), sound
    assert not check.verdict(low["numbers"], limits), low
