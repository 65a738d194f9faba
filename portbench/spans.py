"""The program's own spans and counters, for the per-layer readers.

The program (`mcpt_tpu_torch/trace.py`) records its spans while
torch.profiler records a `Renderer.render` call, stamped on the
profiler's clock, and counts its wavefront while it does; the traced
window's calls are the only calls the profiler sees.  `context(ctx)`
adds to the readers' `ctx`, once:

  spans         the program's spans, (name, start_ns, end_ns, parent,
                call, fields), or None where the program records none
                (a checkout without `mcpt_tpu_torch/trace.py`)
  calls         the `render` spans among them
  prog_counters the program's counters (`trace.counters()` names)
  idle_split    seconds of device idle time by the layer the host was in:
                `traversal` (inside a `trace` span), `shading` (inside a
                `tile_chunk`, outside `trace`), `facade` (inside `render`,
                outside `tile_chunk`), `caller` (outside every `render`)

An idle gap (`trace.idle_gaps` of the device's events) is cut exactly by
the spans: each piece goes to the innermost enclosing span, and a `sync`
span's piece to its parent's layer.  The window is the device's events
and the calls together, so the four parts sum to the window's idle time.
"""

from __future__ import annotations

import numpy as np

from portbench import trace

#: the layer of each span that bounds one, innermost first
LAYERS = (("trace", "traversal"), ("tile_chunk", "shading"),
          ("render", "facade"))


def _program():
    """The program's snapshot, or None where it has no span recorder."""
    try:
        from mcpt_tpu_torch import trace as program_trace
    except ImportError:
        return None
    snap = program_trace.snapshot()
    return snap if snap["spans"] else None


def context(ctx):
    """ctx with the keys above; None where there are no program spans."""
    if "spans" not in ctx:
        snap = _program()
        ctx["spans"] = None if snap is None else snap["spans"]
        ctx["prog_counters"] = None if snap is None else snap["counters"]
    if ctx["spans"] is None:
        return None
    if "calls" not in ctx:
        ctx["calls"] = sum(1 for s in ctx["spans"] if s[0] == "render")
    if "idle_split" not in ctx and ctx["device"]:
        ctx["idle_split"] = idle_split(ctx["device"], ctx["spans"])
    return ctx


def _idle_within(gaps, pieces):
    """Nanoseconds of the sorted, disjoint `gaps` inside the disjoint
    `pieces` [(start, end)]."""
    if not gaps or not pieces:
        return 0
    a = np.array([g[0] for g in gaps], np.int64)
    b = np.array([g[1] for g in gaps], np.int64)
    before = np.concatenate([[0], np.cumsum(b - a)])

    def idle_to(t):
        """Idle nanoseconds of the gaps before instants t."""
        j = np.searchsorted(a, t, side="right") - 1
        inside = np.minimum(t, b[np.maximum(j, 0)]) - a[np.maximum(j, 0)]
        return np.where(j >= 0, before[np.maximum(j, 0)] + inside, 0)

    p = np.array(pieces, np.int64)
    return int((idle_to(p[:, 1]) - idle_to(p[:, 0])).sum())


def idle_split(device, spans):
    """{layer: idle seconds} over the window of `device` events
    [(name, start_ns, end_ns)] and the `render` spans."""
    calls = [(s[1], s[2]) for s in spans if s[0] == "render"]
    stamps = [t for _, s, e in device for t in (s, e)]
    stamps += [t for c in calls for t in c]
    gaps = trace.idle_gaps(device, (min(stamps), max(stamps)))
    split, names, inner = {}, set(), 0
    for name, layer in LAYERS:
        # the idle time inside this span or any span nested in it
        names.add(name)
        within = _idle_within(gaps, trace._union(
            [(n, s, e) for n, s, e, *_ in spans if n in names and e]))
        split[layer] = (within - inner) / 1e9
        inner = within
    split["caller"] = (sum(b - a for a, b in gaps) - inner) / 1e9
    return split


def idle_pct(ctx, layer):
    """A layer's share of the traced wall's device idle time, in % of
    the wall; None where there is nothing to read."""
    ctx = context(ctx)
    if ctx is None or "idle_split" not in ctx or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["idle_split"][layer] / ctx["window_s"]
