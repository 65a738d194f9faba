"""Wavefront iterations per call in the traced window: the program's
counter `path.iterations` (one per loop body of the regen, batched and
chunked wavefronts, counted while torch.profiler records a call) over
its `render` spans."""

from portbench import spans


def read(ctx):
    ctx = spans.context(ctx)
    if ctx is None or not ctx["calls"]:
        return None
    return ctx["prog_counters"]["path.iterations"] / ctx["calls"]
