"""Host seconds of the scene's acceleration build in the set-up (the
BVH's order, the SAH march pack, the super-chunk unions): the program's
`geometry.accel_ns`, which times commit_geometry's `scene.accel` span
always."""

from portbench import spans


def read(ctx):
    ctx = spans.context(ctx)
    if ctx is None or not ctx["prog_counters"].get("geometry.accel_ns"):
        return None
    return ctx["prog_counters"]["geometry.accel_ns"] / 1e9
