"""The precision control on the card: the plain reference put in the
program's place with TF32 on, the nearest precision below the fp32 that
both configurations state, must fail a number of each cell, where the
program passes. At the cell's own size, with a short window; skips without
the cards the cell asks for.

    python -m pytest -q cardbench/tests/test_cardbench_control.py   # on the card
"""
import time

import pytest

from cardbench import calibrate, harness
from cardbench.tests.tiny import ROOT

SECONDS = {"starcoder2.decode": 5.0, "h2o.pipe4": 5.0}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_control_fails_where_the_program_passes(cell):
    import torch

    chips = harness.Bench(ROOT).cell(cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA card(s)")
    limits = harness.Bench(ROOT).cell(cell)["limits"]
    (reading,) = calibrate.readings(ROOT, cell, [2**31 + 77], SECONDS[cell], time.monotonic())
    assert all(reading["program"][k] <= limits[k] for k in limits), reading
    assert any(reading["control"][k] > limits[k] for k in limits), reading
