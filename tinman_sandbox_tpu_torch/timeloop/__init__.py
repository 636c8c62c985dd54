"""Time-integration drivers (counterpart of ``tinman_sandbox_tpu/timeloop``;
only the leapfrog driver is ported so far)."""
from .driver import (
    benchmark_loop,
    check_dp3d,
    leapfrog_step,
    rotated,
    run_leapfrog,
)

__all__ = ["benchmark_loop", "check_dp3d", "leapfrog_step", "rotated",
           "run_leapfrog"]
