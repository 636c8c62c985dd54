"""Device time a step of the hyperviscosity layer's kernels
(``vlap_ms.json``)."""


def read(ctx):
    return ctx.layer_ms()
