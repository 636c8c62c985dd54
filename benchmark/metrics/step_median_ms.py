"""The median over the window's whole cadence periods of a period's time
a step (``rsplit`` steps ending with the remap, between their CUDA
events, over ``rsplit``). Beside the window mean, which every stall of the
host moves, it reads the step that the host and the device give when
nothing stalls them; each period holds its remap."""
import statistics


def read(ctx):
    return statistics.median(ctx.periods_ms) if ctx.periods_ms else None
