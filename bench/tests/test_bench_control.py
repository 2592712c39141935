"""On the card: each cell's control, the reference in the program's place
with its matmuls in TF32, comes out not correct at the cell's own size,
and the program on the same seed comes out correct.  ``bench/readings.py``
takes the same readings over many seeds in one process."""
import time

import pytest

from conftest import ROOT

from bench import harness

CELLS = ("ingp-asdr.frames", "instant-ngp.frames", "ingp-asdr.serve-jump")
SEED = 2 ** 31 + 4242


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_and_the_program_is(card, cell):
    seconds = {"frames": 9.0, "serve-jump": 1.0}[cell.split(".", 1)[1]]
    control, rows = harness.execute(ROOT, cell, SEED, seconds, False, card,
                                    time.perf_counter(), control="tf32")
    assert not control["correct"], rows
    program, rows = harness.execute(ROOT, cell, SEED, 3.0, False, card,
                                    time.perf_counter())
    assert program["correct"], rows
