"""Host time blocked on the device (the program's `sync` spans: the
wavefront's loop tests, the march overflow's count, the film's copy), in
% of the traced wall.  Low beside a high device_idle_pct: the host sets
the pace."""

from portbench import spans


def read(ctx):
    ctx = spans.context(ctx)
    if ctx is None or not ctx["calls"] or ctx["window_s"] <= 0:
        return None
    ns = sum(e - s for n, s, e, *_ in ctx["spans"] if n == "sync" and e)
    return 100.0 * ns / 1e9 / ctx["window_s"]
