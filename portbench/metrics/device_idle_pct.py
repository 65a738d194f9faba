"""Share of the traced calls' wall with no device activity: 100 (1 -
busy / window), busy the union of kernels, copies and sets in
torch.profiler's trace.  None where the trace holds no device event."""


def read(ctx):
    if not ctx["device"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
