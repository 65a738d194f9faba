"""Reading the device's timeline from torch.profiler's Kineto events.

`Recorder` turns the profiler on around whole calls and hands back the
raw events, without the per-event Python objects that torch.profiler's
own summary builds (a traced call of the port issues some 10^5 device
activities).  The reductions below are plain functions of
(name, start, end) intervals, so that the tests can feed them synthetic
timelines:

* `union_seconds`: the time covered by the union of intervals, the
  device's busy time (kernels, copies and sets overlap on streams);
* `idle_gaps`: the gaps inside a window between the union's pieces;
* `top_by_name`: seconds summed by name, the largest first;
* `host_at`: what the host was doing at given instants, the innermost
  host event around each.
"""

from __future__ import annotations

import numpy as np
import torch


class Recorder:
    """Kineto started and stopped by hand: on the card its CUDA activity
    alone (the device's activities and the host's CUDA runtime calls;
    host ops as well would triple a call's traced wall), else the CPU's."""

    def __init__(self, cuda: bool):
        from torch.autograd import ProfilerActivity
        self.acts = {ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU}
        kw = {"use_device": "cuda"} if cuda else {}
        self.config = torch.autograd.profiler.profile(**kw).config(
            create_trace_id=False)

    def start(self):
        from torch.autograd import _enable_profiler, _prepare_profiler
        _prepare_profiler(self.config, self.acts)
        _enable_profiler(self.config, self.acts)

    def stop(self):
        """(device events, host events): lists of (name, start_ns, end_ns)."""
        from torch.autograd import DeviceType, _disable_profiler
        dev, host = [], []
        for e in _disable_profiler().events():
            span = (e.name(), e.start_ns(), e.end_ns())
            if e.device_type() != DeviceType.CUDA:
                host.append(span)
            elif not e.is_user_annotation():
                dev.append(span)
        return dev, host


def union_seconds(intervals) -> float:
    """Seconds covered by the union of [(name, start_ns, end_ns)]."""
    return sum(e - s for s, e in _union(intervals)) / 1e9


def _union(intervals):
    if not intervals:
        return []
    arr = np.array([(s, e) for _, s, e in intervals], np.int64)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    ends = np.maximum.accumulate(arr[:, 1])
    # a new piece starts where a start lies past every earlier end
    new = np.ones(len(arr), bool)
    new[1:] = arr[1:, 0] > ends[:-1]
    starts = arr[new, 0]
    idx = np.nonzero(new)[0]
    last = np.append(idx[1:] - 1, len(arr) - 1)
    return list(zip(starts.tolist(), ends[last].tolist()))


def idle_gaps(intervals, window):
    """[(start_ns, end_ns)] of the window (start_ns, end_ns) not covered
    by any interval."""
    w0, w1 = window
    gaps, t = [], w0
    for s, e in _union(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def top_by_name(items, n=10):
    """[[name, seconds]] of [(name, seconds)] summed by name, the largest
    n first."""
    tot = {}
    for name, sec in items:
        tot[name] = tot.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def host_at(host, instants, reach=64):
    """The name of the innermost host event around each instant (the
    latest started of those that cover it, looking back `reach` events),
    or 'host, outside any op'."""
    ev = sorted(host, key=lambda h: h[1])
    none = "host, outside any op"
    if not ev or not len(instants):
        return [none] * len(instants)
    starts = np.array([h[1] for h in ev], np.int64)
    ends = np.array([h[2] for h in ev], np.int64)
    t = np.asarray(instants, np.int64)
    i = np.searchsorted(starts, t, side="right") - 1
    found = np.full(len(t), -1, np.int64)
    for j in range(reach):
        k = i - j
        ok = (found < 0) & (k >= 0)
        ok[ok] = ends[k[ok]] >= t[ok]
        found[ok] = k[ok]
    return [ev[f][0] if f >= 0 else none for f in found]
