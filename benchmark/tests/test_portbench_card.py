"""Each cell for a moment on the card, at the tests' small sizes:
correct, on the card, and with the device's numbers in the traced run.
At these sizes only the cold replay reaches the card in its window;
the server's deltas and the replica's rounds stay below the host/device
crossover."""

import time

import pytest

from benchmark import run
from benchmark.tests.small import SMALL


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_correct_on_the_card(card, cell, trace):
    res = run.run_cell(run.ROOT, cell, 99, 2.0, trace, "cuda",
                       overrides=SMALL[cell], t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == card
    if trace:
        assert res["device"]["window_s"] > 0
        if cell == "fanin_1k.cold_replay":
            assert res["device"]["busy_s"] > 0
