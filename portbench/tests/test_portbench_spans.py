"""The readers of the program's spans and counters (portbench/spans.py):
on a synthetic timeline each reads its value and the idle split is a
partition; the older readers read the same beside the new keys; a CPU
run prints every one of them."""

import pytest

from conftest import ROOT, tiny
from portbench import spans, trace
from portbench.harness import load_module

NEW = ("iterations_per_call", "live_lane_pct", "idle_in_shading_pct",
       "idle_in_trace_pct", "idle_in_facade_pct", "host_wait_pct",
       "accel_build_s")
OLD = ("device_idle_pct", "device_ops_per_msample",
       "trace_launches_per_msample", "k1_ms_per_msample",
       "k2_ms_per_msample", "commit_s", "warm_s")


def _read(name, ctx):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                       f"reader_{name}").read(ctx)


def _ctx():
    """Two calls over 0-100 ns.  Call 1 (0-40): a tile-chunk 5-30 with a
    trace 10-20 and a loop test 22-24, then the film's copy 32-38.  Call
    2 (50-90): a tile-chunk 55-85 with a trace 60-70 and in it the march
    overflow's count 62-64.  The device is busy 0-12, 18-23, 36-56,
    66-68, 95-100."""
    s = [("render", 0, 40, -1, 1, {"call": 1}),
         ("tile_chunk", 5, 30, 0, 1, {}),
         ("trace", 10, 20, 1, 1, {}),
         ("sync", 22, 24, 1, 1, {"site": "path.regen"}),
         ("sync", 32, 38, 0, 1, {"site": "film"}),
         ("render", 50, 90, -1, 2, {"call": 2}),
         ("tile_chunk", 55, 85, 5, 2, {}),
         ("trace", 60, 70, 6, 2, {}),
         ("sync", 62, 64, 7, 2, {"site": "march_overflow"})]
    dev = [("k", 0, 12), ("k", 18, 23), ("copy", 36, 56), ("k", 66, 68),
           ("k", 95, 100)]
    counters = {"path.iterations": 30, "path.lanes": 300,
                "path.live_lanes": 75, "geometry.accel_ns": 1_250_000_000,
                "dense_sweep.launches": 7}
    return {"device": dev, "busy_s": trace.union_seconds(dev),
            "window_s": 100e-9, "samples": 2_000_000, "counters":
            {"launches": 4, "corridor_launches": 0, "pair_launches": 0},
            "commit_s": 1.5, "warm_s": 0.5, "spans": s,
            "prog_counters": counters}


def test_each_reader_reads_the_synthetic_timeline():
    # idle: 12-18 (trace), 23-36 (shading 23-30, facade 30-36), 56-66
    # (shading 56-60, trace 60-66), 68-95 (trace 68-70, shading 70-85,
    # facade 85-90, caller 90-95)
    want = {"iterations_per_call": 15.0, "live_lane_pct": 25.0,
            "idle_in_trace_pct": 14.0, "idle_in_shading_pct": 26.0,
            "idle_in_facade_pct": 11.0, "host_wait_pct": 10.0,
            "accel_build_s": 1.25}
    for name in NEW:
        assert _read(name, _ctx()) == pytest.approx(want[name]), name


def test_the_idle_split_is_a_partition():
    ctx = _ctx()
    parts = sum(_read(n, ctx) for n in ("idle_in_facade_pct",
                                        "idle_in_shading_pct",
                                        "idle_in_trace_pct"))
    caller = 100.0 * ctx["idle_split"]["caller"] / ctx["window_s"]
    assert caller == pytest.approx(5.0)
    assert parts + caller == pytest.approx(_read("device_idle_pct", ctx),
                                           abs=1e-9)


def test_older_readers_read_the_same_beside_the_new_keys():
    bare = _ctx()
    for key in ("spans", "prog_counters"):
        del bare[key]
    full = spans.context(_ctx())
    assert {"calls", "idle_split"} <= set(full)
    for name in OLD:
        assert _read(name, dict(bare)) == _read(name, full), name


def test_no_program_spans_no_reading(monkeypatch):
    """A program that records no spans (an older checkout, or an
    unprofiled run) leaves every new metric out of the line."""
    monkeypatch.setattr(spans, "_program", lambda: None)
    ctx = _ctx()
    del ctx["spans"], ctx["prog_counters"]
    for name in NEW:
        assert _read(name, dict(ctx)) is None, name


def test_a_cpu_run_prints_every_new_metric(monkeypatch):
    """On the CPU the profiler sees no device: the aten ops stand in for
    its activities, so the idle split reads the host's own gaps."""
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
    assert set(NEW) <= set(m)
    assert m["iterations_per_call"] > 1
    assert 0 < m["live_lane_pct"] <= 100
    assert m["accel_build_s"] > 0
    parts = (m["idle_in_facade_pct"] + m["idle_in_shading_pct"]
             + m["idle_in_trace_pct"])
    # the rest is the idle time outside every call: the caller's fold
    assert parts > 0
    assert 0 <= m["device_idle_pct"] - parts < 5.0
