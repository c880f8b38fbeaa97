"""The share of the window in which no operation ran on the device:
100 minus the union of the device operations' intervals over the window
(torch.profiler's device activity)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
