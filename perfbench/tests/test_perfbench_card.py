"""Each cell end to end on the card, at its own size, with a short
window: the line comes out correct.  Run on the card with
``python -m pytest perfbench/tests -m card``; skipped without one."""

import pytest

from perfbench import common, run

CELLS = [w["name"] for w in common.load_json("..", "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    out = run.run(cell, 2 ** 31 + 99, 2.0, False, str(card))
    assert out["device"]["platform"] == "gpu"
    assert out["correct"] is True, out["check"]
