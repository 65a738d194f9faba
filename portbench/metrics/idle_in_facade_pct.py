"""Device idle time while the host was in Renderer.render outside its
tile-chunks (index set-up, the chunks' sum, the film's copy), in % of
the traced wall (portbench/spans.py).  With idle_in_shading_pct,
idle_in_trace_pct and the idle time outside every call (the caller's
fold), it makes up device_idle_pct."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "facade")
