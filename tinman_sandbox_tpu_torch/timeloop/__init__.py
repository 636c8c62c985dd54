"""Time integration (counterpart of ``tinman_sandbox_tpu/timeloop``): the
leapfrog loop, the SSPRK3 step and biharmonic hyperviscosity."""
from .driver import (
    benchmark_loop,
    check_dp3d,
    leapfrog_step,
    rotated,
    run_leapfrog,
)
from .hyperviscosity import apply_hyperviscosity, biharmonic_wk
from .rk import ssprk3_step

__all__ = ["apply_hyperviscosity", "benchmark_loop", "biharmonic_wk",
           "check_dp3d", "leapfrog_step", "rotated", "run_leapfrog",
           "ssprk3_step"]
