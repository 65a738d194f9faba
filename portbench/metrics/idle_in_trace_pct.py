"""Device idle time while the host was in the traversal (inside a
`trace` span: routing, ray sort, launch, unsort, quadric merge), in % of
the traced wall (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "traversal")
