"""`correct` comes out false where it has to: for the control (the lower
precision each cell's mix names) and for each fault a cell can have,
planted in the timed path underneath a run that otherwise goes as usual.
On the CPU at tiny widths; the card's version runs the controls at the
cells' own sizes."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.faults import FAULTS as FAULTS_BY_LOOP
from benchmark.tests.tiny import tiny_cell

CELLS = ["cardiac.full-f32", "camus.paper-f32", "camus.temporal-f32"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    bench, cell = tiny_cell(workload, control=True)
    result = run.run_cell(bench, cell)
    assert not result["correct"], result["checks"]


FAULTS = [(w, f) for w in CELLS for f in FAULTS_BY_LOOP["train"]]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_a_fault_underneath_is_not_correct(workload, fault):
    bench, cell = tiny_cell(workload)
    with FAULTS_BY_LOOP[cell.traffic["loop"]][fault]():
        result = run.run_cell(bench, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(workload, card):
    """The control at the cell's own size, on three seeds."""
    import time

    bench = run.load_benchmark()
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        cell = run.make_cell(bench, workload, seed, 2.0, False, card, time.perf_counter(),
                             control=True)
        assert not run.run_cell(bench, cell)["correct"], seed


