"""Device operations (kernels, copies, fills) a step issues, over the
traced slice's whole number of remap periods."""


def read(ctx):
    return len(ctx.trace.device_ops) / ctx.trace.steps
