"""Device activities (kernels, copies, sets) in the traced window per
10^6 pixel samples: the eager wavefront's launch count, which the host
pays for one at a time."""


def read(ctx):
    if not ctx["device"] or not ctx["samples"]:
        return None
    return len(ctx["device"]) / (ctx["samples"] / 1e6)
