"""The control's paths rehearsed on the CPU at tiny size: the serving
control takes the sample of a real window and puts the fp8 reference's
frames in the program's place; the training control and the half-batch
fault recompute the steps a run compares.  Each reads further from the
reference than the program does on the same seed."""

import math
import tempfile

import pytest

from t2v_bench import control, run
from t2v_bench.tests import tiny

SEED = 2 ** 31 + 7


def _program_checks(cell):
    checks = run.run_cell("tiny", SEED, 0.5, False, "cpu", cell)["checks"]
    return {k: v["value"] for k, v in checks.items()}


def _with_limits(cell, names):
    cell["limits"] = {k: {"limit": 1.0} for k in names}
    return cell


def test_serving_control_reads_further_than_the_program():
    cell = _with_limits(tiny.serve_cell(), ["video"])
    with tempfile.TemporaryDirectory() as wd:
        numbers = control.serve_control(cell, SEED, "cpu", wd, 0.5)
    assert set(numbers) == {"video"} and math.isfinite(numbers["video"])
    assert numbers["video"] > _program_checks(cell)["video"]


@pytest.mark.parametrize("fault", ["", "half_batch"])
def test_training_control_reads_further_than_the_program(fault):
    cell = tiny.train_cell()
    cell["traffic"]["yaml"]["mixed_precision"] = None
    _with_limits(cell, ["grad1", "change"])
    with tempfile.TemporaryDirectory() as wd:
        numbers = control.train_control(cell, SEED, "cpu", wd, fault)
    program = _program_checks(cell)
    assert numbers["grad1"] > program["grad1"]
