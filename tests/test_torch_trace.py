"""The renderer's spans and counters (mcpt_tpu_torch/trace.py), on the
CPU: the off path dispatches the same ops and records nothing, the spans
nest by layer, the wavefront's counters match a count made beside them,
and the spans share torch.profiler's clock."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mcpt_tpu_torch import trace
from mcpt_tpu_torch.integrators import path
from mcpt_tpu_torch.render.renderer import Renderer, render_tile_regen
from mcpt_tpu_torch.scene import builtin

RES, SPP = 12, 2


@pytest.fixture
def fresh():
    """Tracing off and its record empty, before and after the test."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _cornell(away=False, depth_max=6):
    cfg = builtin.cornell_box(res=RES, spp=SPP, depth_max=depth_max)
    if away:
        # looking out of the box's open side: every camera ray misses
        cfg.camera.look_at = np.array([0.0, 1.0, 20.0], np.float32)
    return Renderer(cfg, device="cpu")


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_off_path_dispatches_the_same_ops_and_records_nothing(fresh):
    r = _cornell()
    idx = torch.arange(RES * RES)

    def chunk():
        with _Ops() as ops:
            film = render_tile_regen(r.scene, r.camera, r.integrator, idx,
                                     SPP, frame_base=3)
        return film, Counter(ops.names)

    film_off, off = chunk()
    assert trace.snapshot()["spans"] == []
    assert trace.snapshot()["counters"]["path.iterations"] == 0
    trace.enable()
    film_on, on = chunk()
    tests = trace.snapshot()["counters"]["path.iterations"] + 1
    # the loop test reads a count where it read a flag: one op for one
    assert sum(off.values()) == sum(on.values())
    assert off - on == Counter({"aten.any": tests})
    assert on - off == Counter({"aten.sum": tests})
    assert torch.equal(film_off, film_on)


def test_spans_nest_by_layer(fresh):
    trace.enable()
    r = _cornell()
    r.render(spp=SPP, tile=RES * RES // 2, spp_chunk=1)
    spans = trace.snapshot()["spans"]
    names = [s[0] for s in spans]
    compile_i = names.index("scene.compile")
    assert spans[names.index("scene.accel")][3] == compile_i
    calls = [i for i, n in enumerate(names) if n == "render"]
    assert len(calls) == 1 and spans[calls[0]][5] == {"call": 1}
    parent = {"tile_chunk": {"render"}, "trace": {"tile_chunk"},
              "sync": {"tile_chunk", "render"}}
    for name, start, end, up, call, fields in spans[calls[0] + 1:]:
        assert spans[up][0] in parent[name]
        assert call == 1
        assert spans[up][1] <= start <= end <= spans[up][2]
        if name == "sync":
            want = "film" if spans[up][0] == "render" else "path.regen"
            assert fields["site"] == want
    # two tiles of two one-sample chunks, each tile's film copied once
    assert names.count("tile_chunk") == 4
    assert Counter(s[5].get("site") for s in spans)["film"] == 2


@pytest.mark.parametrize("case", ["cornell", "away", "chunked"])
def test_counters_match_a_count_beside_them(fresh, monkeypatch, case):
    r = _cornell(away=case == "away")
    traced = []
    closest = path.scene_closest

    def counted(scene, o, d, t_min=None, t_max=None, **kw):
        # the lanes a loop body traces live (dead lanes get t_max 0); the
        # chunked body's primary trace, before its loop, has no t_max
        traced.append(None if t_max is None else int((t_max > 0).sum()))
        return closest(scene, o, d, t_min=t_min, t_max=t_max, **kw)

    monkeypatch.setattr(path, "scene_closest", counted)
    trace.enable()
    r.render(spp=SPP, tile=RES * RES,
             engine="chunked" if case == "chunked" else "regen")
    c = trace.snapshot()["counters"]
    bodies = [x for x in traced if x is not None]
    assert traced.count(None) == (SPP if case == "chunked" else 0)
    assert c["path.iterations"] == len(bodies)
    assert c["path.lanes"] == RES * RES * len(bodies)
    if case == "chunked":
        # lanes live at the test; RR and the BSDF sample end some before
        # the body traces
        assert sum(bodies) <= c["path.live_lanes"] <= c["path.lanes"]
    else:
        # after regeneration the lanes with work are the lanes traced live
        assert c["path.live_lanes"] == sum(bodies)
    assert 0 < c["path.live_lanes"] <= c["path.lanes"]
    if case == "away":
        # every sample ends at its first vertex: one iteration a sample
        assert c["path.iterations"] == SPP
        assert c["path.live_lanes"] == c["path.lanes"]


def test_a_profiled_call_records_on_the_profilers_clock(fresh):
    from portbench.trace import Recorder
    r = _cornell()
    rec = Recorder(False)
    rec.start()
    r.render(spp=1, tile=RES * RES)
    _, host = rec.stop()
    assert not trace.on
    spans = trace.snapshot()["spans"]
    (call,) = [s for s in spans if s[0] == "render"]
    aten = [h for h in host if h[0].startswith("aten::")]
    assert aten
    assert all(call[1] <= s and e <= call[2] for _, s, e in aten)
    # an unprofiled call, tracing off, records nothing more
    r.render(spp=1, tile=RES * RES)
    assert trace.snapshot()["spans"] == spans
