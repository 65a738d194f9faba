"""The renderer's spans and counters, on torch.profiler's clock.

Tracing is off unless `enable()` turns it on, or torch.profiler records
while `Renderer.render` runs: such a call records its spans for its own
length, as `record_function` records only under the profiler.  Off,
`span` returns one shared no-op context (one test of a module-level bool
at each site): nothing is allocated, no device op is launched, and the
counter that needs a device read (`path.live_lanes`) is not read.

A span is (name, start_ns, end_ns, parent, call, fields), stamped by
`time.time_ns()`: Kineto stamps its host and device events in Unix-epoch
nanoseconds, so spans and a profiler trace lie on one timeline.
`parent` indexes the enclosing span (-1: none), `call` numbers the
`render` span around it (0: outside any).  The spans:

  render       Renderer.render, one a call
  tile_chunk   each tile function call in it: the integrator's wavefront
  trace        ops/scene_intersect.py scene_closest and scene_any
               (routing, ray sort, launch, unsort, the quadric merge)
  sync         the host blocked on the device; field `site`: the loop
               tests of integrators/path.py and volpath.py, the march
               overflow's count (ops/traversal.py), the film's copy
  scene.parse, scene.compile, scene.accel
               load_config, compile_scene, and in it the BVH, the SAH
               march pack and the super-chunk unions

The spans inside an iteration that replays as a CUDA graph
(integrators/path.py::_regen_graphed: the unbatched regen body on the
card) fire once, at its capture, and not at its replays: there the
iteration's `trace` spans are missing, and its host time is the replay's
launch, inside `tile_chunk`.

`counters()` lists every counter of the renderer.  `chrome_trace()`
gives a snapshot as Chrome trace-event JSON (Perfetto, chrome://tracing).
"""

from __future__ import annotations

import time

import torch

#: spans and the wavefront's counters record while True
on = False
_spans: list = []
_open: list = []      # indexes of the open spans, innermost last
_call = 0             # the open render span's call number
_calls = 0
_base: dict = {}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name, fields):
        self.rec = [name, 0, 0, _open[-1] if _open else -1, _call, fields]

    def __enter__(self):
        _open.append(len(_spans))
        _spans.append(self.rec)
        self.rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _open.pop()
        return False


class _Call(_Span):
    """A render span; `follow`: tracing was off and torch.profiler
    records, so it is on for this call alone."""

    __slots__ = ("follow",)

    def __init__(self, follow):
        global on, _calls, _call
        self.follow = follow
        on = True
        _calls += 1
        _call = _calls
        super().__init__("render", {"call": _calls})

    def __exit__(self, *exc):
        global on, _call
        super().__exit__(*exc)
        _call = 0
        if self.follow:
            on = False
        return False


def span(name: str, **fields):
    """A context that records the span `name` while tracing is on."""
    if not on:
        return _NOOP
    return _Span(name, fields)


def render_call():
    """The `render` span of one Renderer.render call, recorded while
    tracing is on or torch.profiler records."""
    if on:
        return _Call(False)
    if torch.autograd._profiler_enabled():
        return _Call(True)
    return _NOOP


def enable():
    global on
    on = True


def disable():
    global on
    on = False


def reset():
    """Forget the spans and take the counters' base; call it between
    calls, with no span open."""
    global _calls, _base
    _spans.clear()
    _calls = 0
    _base = counters()


def counters() -> dict:
    """Every counter of the renderer, as `module.name`: the traversal's
    kernel launches (a replayed iteration credits the launches its
    capture recorded) and the acceleration build's nanoseconds (counted
    always), the wavefront's iterations, those of them replayed as a CUDA
    graph, lanes and live lanes (counted while tracing is on)."""
    from mcpt_tpu_torch.integrators import path
    from mcpt_tpu_torch.ops import (dense_sweep, march_sweep, packet_sweep,
                                    pair_sweep)
    from mcpt_tpu_torch.scene import geometry
    where = {
        "dense_sweep": (dense_sweep, ("launches", "any_hit_launches")),
        "march_sweep": (march_sweep, ("launches", "any_hit_launches")),
        "packet_sweep": (packet_sweep, ("launches", "any_hit_launches")),
        "pair_sweep": (pair_sweep, ("corridor_launches", "pair_launches")),
        "path": (path, ("iterations", "graph_iterations", "lanes",
                        "live_lanes")),
        "geometry": (geometry, ("accel_ns",)),
    }
    return {f"{m}.{n}": getattr(mod, n)
            for m, (mod, names) in where.items() for n in names}


def snapshot() -> dict:
    """{'spans': [(name, start_ns, end_ns, parent, call, fields)],
    'counters': counters() less their values at the last reset()}."""
    now = counters()
    return {"spans": [tuple(s) for s in _spans],
            "counters": {k: v - _base.get(k, 0) for k, v in now.items()}}


def chrome_trace(snap: dict) -> dict:
    """A snapshot as Chrome trace-event JSON: each finished span a
    complete event (microseconds), its call and fields its args; the
    counters under otherData."""
    events = [{"name": name, "ph": "X", "pid": 0, "tid": 0,
               "ts": s / 1e3, "dur": (e - s) / 1e3,
               "args": {"call": call, **fields}}
              for name, s, e, _, call, fields in snap["spans"] if e]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"counters": snap["counters"]}}
