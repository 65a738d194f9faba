"""The program's own traversal launch counters (ops/dense_sweep.py,
march_sweep.py, packet_sweep.py `launches`, which count any-hit launches
too; ops/pair_sweep.py `corridor_launches` + `pair_launches`) over the
traced window, per 10^6 pixel samples."""

NAMES = ("launches", "corridor_launches", "pair_launches")


def read(ctx):
    n = sum(ctx["counters"].get(k, 0) for k in NAMES)
    if not n or not ctx["samples"]:
        return None
    return n / (ctx["samples"] / 1e6)
