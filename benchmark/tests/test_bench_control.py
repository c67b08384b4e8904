"""The output check separates a faithful run from a wrong one.

- The control, the reference computed one precision lower in the program's
  place, fails the limits where the program passes them (tiny size, CPU).
- With the timed path broken underneath, a run's `correct` comes out false:
  a step that returns its state unchanged, half of the batch left out (its
  place filled from the rest), an answer altered where it is produced.
  (No cell spans chips, so no exchange between chips can be left out.)
- On the card, at each cell's own size: the same readings on three seeds
  (marked `gpu`; skipped without a card).
"""

import pytest
import torch

from benchmark import faults
from benchmark.tests.conftest import CELLS, tiny_limits

GEN = sorted(c for c in CELLS if not c.startswith("train"))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("low", ["tf32", "fp8", "int8"])
def test_control_fails_where_the_program_passes(cell, low, run_tiny):
    res = run_tiny(cell, control=low)
    limits = tiny_limits(cell)
    assert res["correct"] is True
    failed = [k for k, v in res["control_checks"].items() if k in limits and v > limits[k]]
    assert failed, res["control_checks"]


@pytest.mark.parametrize("fault", faults.GENERATION)
@pytest.mark.parametrize("cell", GEN)
def test_generation_faults_are_caught(cell, fault, run_tiny):
    with getattr(faults, fault)():
        assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("fault", faults.TRAINING)
def test_training_faults_are_caught(fault, run_tiny):
    with getattr(faults, fault)():
        assert run_tiny("train.tiny")["correct"] is False


@pytest.mark.gpu
def test_control_on_the_card():
    """Each cell at its own size on three seeds: every run correct, and the
    control fails one of its numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import harness
    from benchmark.control import control_precision

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        low = control_precision(bench, cell["name"])
        limits = harness.load_json(harness.BENCH_DIR / "limits" / f"{cell['name']}.json")
        for seed in (101, 2**31 + 7, 987654321):
            res = harness.run_cell(cell["name"], seed, 5, False, control=low)
            assert res["correct"] is True, res["checks"]
            assert any(v > limits[k] for k, v in res["control_checks"].items() if k in limits)
