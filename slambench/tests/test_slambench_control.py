"""The lower-precision control, on the card: the plain reference computed
with TF32 in its matrix products (the precision below the configuration's
float32 with TF32 off) put in the program's place must come out not
correct under each cell's limits, as the harness judges it
(``run.py --control`` at the cell's own size; here at a tiny size). A
CUDA test: it skips without a card."""

import pytest
import torch

from slambench.lib.harness import run_cell
from slambench.tests.tiny import short_init, tiny_root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tum1.desk", "replica.room0"])
def test_control_fails(tmp_path, monkeypatch, card, cell):
    short_init(monkeypatch)
    res = run_cell(tiny_root(tmp_path, cell), cell, 2**31 + 5, 0.5, False, card, control=True)
    # The limits hold the cell's own size; at this size only the control's
    # side is asserted.
    assert res["checks"]
    assert res["control"]["correct"] is False, res["control"]["checks"]
