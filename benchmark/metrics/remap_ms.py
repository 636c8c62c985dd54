"""Device time a step of the remap layer's kernels (``remap_ms.json``);
the remap runs every rsplit-th step, so its time is amortised over all."""


def read(ctx):
    return ctx.layer_ms()
