"""The 95th percentile of the window's step times (between consecutive
CUDA events) in a cell whose steps wait on the host's dispatch: there the
tail swings with the host and decides no PR."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.step_times_ms, 95))
