"""The reader of `graph_iteration_pct` (portbench/metrics/
graph_iteration_pct.py): on a synthetic counter set it reads the replayed
share, it reads nothing where the program has no such counter, and a CPU
run, where no CUDA graph is captured, reads 0."""

import pytest

from conftest import ROOT, tiny
from portbench import trace
from portbench.harness import load_module


def _read(ctx):
    return load_module(ROOT / "portbench" / "metrics" /
                       "graph_iteration_pct.py",
                       "reader_graph_iteration_pct").read(ctx)


def _ctx(**counters):
    """One call over 0-100 ns, 30 wavefront iterations."""
    s = [("render", 0, 40, -1, 1, {"call": 1}),
         ("tile_chunk", 5, 30, 0, 1, {})]
    return {"device": [("k", 0, 12)], "busy_s": 12e-9, "window_s": 100e-9,
            "samples": 2_000_000, "counters": {"launches": 4},
            "spans": s, "prog_counters": {"path.iterations": 30,
                                          **counters}}


def test_graph_iteration_pct_reads_the_replayed_share():
    assert _read(_ctx(**{"path.graph_iterations": 24})) == \
        pytest.approx(80.0)
    assert _read(_ctx(**{"path.graph_iterations": 0})) == 0


def test_graph_iteration_pct_reads_nothing_without_the_counter():
    # a program without the counter (an older checkout) reads nothing
    assert _read(_ctx()) is None
    ctx = _ctx()
    del ctx["spans"], ctx["prog_counters"]
    assert _read(ctx) is None


def test_a_cpu_run_reads_no_replayed_iteration(monkeypatch):
    """On the CPU the regen body runs eagerly: the metric is in the line
    and reads 0."""
    from mcpt_tpu_torch import trace as program_trace
    from portbench.harness import Cell, run_cell
    stop = trace.Recorder.stop

    def ops_as_device(self):
        _, host = stop(self)
        return [h for h in host if h[0].startswith("aten::")], host

    monkeypatch.setattr(trace.Recorder, "stop", ops_as_device)
    program_trace.reset()
    res = run_cell(Cell("cornell-box.preview"), 11, 0.3, True, device="cpu",
                   shrink=tiny(), log=lambda *_: None, min_calls=3)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["iterations_per_call"] > 1
    assert m["graph_iteration_pct"] == 0
