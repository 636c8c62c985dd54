"""The whole cadence step's share of the chip's peak, in percent: the
larger of the step's compulsory bytes over 3.35 TB/s and its operations
over 67 TFLOP/s (``work/step.py``), over the timed window's step time."""


def read(ctx):
    return 100.0 * ctx.bound_ms("step") / ctx.step_ms
