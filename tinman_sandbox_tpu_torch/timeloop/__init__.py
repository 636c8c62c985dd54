"""Time integration (counterpart of ``tinman_sandbox_tpu/timeloop``): the
leapfrog loop, the SSPRK3 step, biharmonic hyperviscosity, the tracer step
and the full model step."""
from .driver import (
    benchmark_loop,
    check_dp3d,
    leapfrog_step,
    rotated,
    run_leapfrog,
)
from .hyperviscosity import apply_hyperviscosity, biharmonic_wk
from .prim import air_mass, prim_run_step
from .rk import ssprk3_step
from .tracer import advance_qdp, euler_step, ssprk3_tracer_step

__all__ = ["advance_qdp", "air_mass", "apply_hyperviscosity",
           "benchmark_loop", "biharmonic_wk", "check_dp3d", "euler_step",
           "leapfrog_step", "prim_run_step", "rotated", "run_leapfrog",
           "ssprk3_step", "ssprk3_tracer_step"]
