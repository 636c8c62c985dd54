"""Device time a step of the dss layer's kernels (``dss_ms.json``)."""


def read(ctx):
    return ctx.layer_ms()
