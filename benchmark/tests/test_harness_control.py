"""The control fails the comparison that sound runs pass.

The control is the reference put in the program's place and computed in the
precision below the configuration's: float32 with TF32 matrix products below
float32 with TF32 off, and float32 with TF32 off below float64.  On the card
(``gpu``) at each cell's own size, one seed, a short window: the program's
readings stay within the cell's limits and the control's pass at least one
of them.  On the CPU at a tiny size the
control's gaps are far above the program's.
"""
from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.control import readings
from benchmark.reference import controller as R
from benchmark.tests.conftest import CELLS, ROOT


def test_each_precision_has_its_reference_and_control():
    assert R.reference(torch.float32) is R.REF and R.control(torch.float32) is R.TF32
    assert R.REF == R.Prec(torch.float32, tf32=False) and R.TF32 == R.Prec(torch.float32, True)
    assert R.REF.guards == R.TF32.guards == (1e-7, 1e-9, 1e10)
    f64 = R.reference(torch.float64)
    assert f64 == R.Prec(torch.float64, tf32=False) and f64.guards == (1e-14, 1e-11, 1e14)
    assert R.control(torch.float64) is R.REF


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_fails_where_the_program_passes_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    c = harness.load_cell(ROOT, cell)
    r = readings(c, 4000000001, 5.0)
    limits = c.check["limits"]
    assert harness.correct(harness.checks_of(r["program"], limits)), r
    assert not harness.correct(harness.checks_of(r["control"], limits)), r


@pytest.mark.parametrize("cell", ["sweep_diff_n80_b4096", "fleet_mixed_n80_moving"])
def test_the_control_reads_far_above_the_program_on_the_cpu(tiny, cell):
    c = harness.load_cell(tiny, cell, tiny)
    r = readings(c, 77, 2.0, device="cpu")
    assert r["control"]["us_gap"] > 10 * r["program"]["us_gap"], r
