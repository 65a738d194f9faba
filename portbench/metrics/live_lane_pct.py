"""Share of the wavefront's lanes with work at its loop tests: 100 x the
program's `path.live_lanes` (lanes alive or with samples left at each
test; after regeneration, the lanes traced live) over `path.lanes` (the
lanes each iteration carried), over the traced window."""

from portbench import spans


def read(ctx):
    ctx = spans.context(ctx)
    if ctx is None or not ctx["prog_counters"]["path.lanes"]:
        return None
    c = ctx["prog_counters"]
    return 100.0 * c["path.live_lanes"] / c["path.lanes"]
