"""Host seconds of the warm-up call (the facade's first call: the kernel
library's load, or its build in a fresh checkout, and one tile-chunk or
pass of the cell's own shapes), up to a synchronised device."""


def read(ctx):
    return ctx["warm_s"]
