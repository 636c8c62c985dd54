"""Device time a step of the caar layer's kernels (``caar_ms.json``)."""


def read(ctx):
    return ctx.layer_ms()
