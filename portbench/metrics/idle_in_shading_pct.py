"""Device idle time while the host was in the integrator's wavefront
(inside a `tile_chunk` span, outside `trace`), in % of the traced wall
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "shading")
