"""Share of the wavefront's iterations that ran as the replay of a
captured CUDA graph: 100 x the program's `path.graph_iterations` (the
unbatched regen body's iterations replayed, integrators/path.py::
_regen_graphed) over `path.iterations`, over the traced window.  None
where the program counts no such iterations (a checkout without the
counter)."""

from portbench import spans


def read(ctx):
    ctx = spans.context(ctx)
    if ctx is None:
        return None
    c = ctx["prog_counters"]
    if "path.graph_iterations" not in c or not c.get("path.iterations"):
        return None
    return 100.0 * c["path.graph_iterations"] / c["path.iterations"]
