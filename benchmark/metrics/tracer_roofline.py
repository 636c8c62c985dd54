"""The tracer layer's share of its roofline: the bound of its frozen work
(``work/tracer.py``) on the published peaks over its device time a step,
in percent."""


def read(ctx):
    return ctx.roofline("tracer")
