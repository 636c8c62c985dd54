"""Device time a step of the tracer layer's kernels (``tracer_ms.json``)."""


def read(ctx):
    return ctx.layer_ms()
