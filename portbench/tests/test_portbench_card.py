"""On the card: the control (the reference in bfloat16 in the program's
place) at each cell's own size, on three seeds, is not correct.

    python -m pytest portbench/tests -m cuda -q -s

prints each reading, which PERF.md's limits were set from."""

import json

import pytest

from conftest import ROOT
from portbench import check
from portbench.harness import Cell, control

#: distinct calls a run's window makes in each cell (PERF.md: the
#: cells' runs at run_seconds), which the control makes in their place
CALLS = {"gold-sphere.film": 11, "cornell-box.preview": 256}


def _cells():
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_on_the_card(card, cell):
    c = Cell(cell)
    for seed in (101, 202, 303):
        numbers = control(c, seed, CALLS[cell], device=card)
        print(f"control {cell} seed {seed}: " + json.dumps(numbers))
        assert not check.verdict(numbers)[0], numbers
