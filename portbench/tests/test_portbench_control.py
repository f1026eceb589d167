"""The control: the reference one precision down (TF32) in the program's
place, driven through the cell's own run, fails the cells' limits; at
the configuration's own precision it passes.  At a tiny size on the CPU
here; at the cells' own sizes on the card (``card``)."""

import pytest
import torch

from portbench import control, harness

from tiny import cell

CELLS = ["trec_covid.rerank", "trec_covid.gate", "rag_svc.bundle"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_tf32_control_fails_and_float32_passes(name, seed):
    c = cell(name)
    low = control.control(c, seed, torch.device("cpu"), "tf32", seconds=0.5)
    assert not harness.judge(low, c.limits), low
    same = control.control(c, seed, torch.device("cpu"), "f32", seconds=0.5)
    assert harness.judge(same, c.limits), same


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell(name)
    low = control.control(c, 2**31 + 9, torch.device("cuda", 0), "tf32", seconds=20.0)
    assert not harness.judge(low, c.limits), low
