"""Device milliseconds of kernel K1 (csrc/dense_sweep.cu,
`dense_sweep_kernel`) in the traced window per 10^6 pixel samples."""

KERNEL = "dense_sweep_kernel"


def read(ctx):
    ms = sum(e - s for n, s, e in ctx["device"] if KERNEL in n) / 1e6
    if not ms or not ctx["samples"]:
        return None
    return ms / (ctx["samples"] / 1e6)
