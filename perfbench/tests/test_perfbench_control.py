"""The control on the card: the plain reference with float8 products put in
the program's place fails the cell's limits, on three seeds, at the cell's
widths and a size a test run holds (one generation batch; the training
cell's compared pairs at its batch; the benchmark's runs do not run it).
``perfbench.calibrate`` reads it at the cell's own size."""

import pytest
import torch

from perfbench import harness, run

CELLS = ["gen.map3dbn512l.b8", "train.map3dbn.b32"]


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [61, 62, 63])
def test_control_fails_the_limits(cell_name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's widths on the card")
    cell = harness.Spec().cell(cell_name)
    if "sample" in cell.traffic:
        cell.traffic = dict(cell.traffic, sample=1)
    drv = harness.driver(cell.traffic["driver"])
    out = drv.control(cell, seed, torch.device("cuda"), torch.float8_e4m3fn)
    numbers = out.get("numbers", out)
    numbers = {k: numbers[k] for k in cell.limits}
    assert run.judge(numbers, cell.limits)  # at least one number over its limit
