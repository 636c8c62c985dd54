"""The share of the traced slice in which no operation ran on the device,
in percent: 1 - busy / window."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
