"""On the card, at each film cell's own size: a call that renders half
of its samples and returns their mean as the whole call's is not
correct; the noise check catches it (its readings go to PERF.md).

    python -m pytest portbench/tests -m cuda -q -s"""

import json

import pytest

from conftest import ROOT
from portbench.harness import Cell, run_cell
from test_portbench_faults import Broken


def _films():
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["traffic"] == "film"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _films())
def test_half_samples_fail_on_the_card(card, cell):
    for seed in (404, 505, 606):
        res = run_cell(Cell(cell), seed, 1.0, False, device=card,
                       wrap=lambda r: Broken(r, "half_samples"),
                       log=lambda *_: None, min_calls=8)
        print(f"half_samples {cell} seed {seed}: " + json.dumps(res["check"]))
        assert not res["correct"], res["check"]
