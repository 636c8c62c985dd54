"""Time integration (counterpart of ``tinman_sandbox_tpu/timeloop``): the
leapfrog loop, the SSPRK3 step, biharmonic hyperviscosity, the tracer step,
the full model step (with the vertical remap and the mass fixer) and the npz
checkpoints."""
from .checkpoint import (
    checkpoint_meta,
    load_checkpoint,
    load_packed_checkpoint,
    save_checkpoint,
    save_packed_checkpoint,
)
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
           "benchmark_loop", "biharmonic_wk", "check_dp3d", "checkpoint_meta",
           "euler_step",
           "leapfrog_step", "load_checkpoint", "load_packed_checkpoint",
           "prim_run_step", "rotated", "run_leapfrog", "save_checkpoint",
           "save_packed_checkpoint", "ssprk3_step", "ssprk3_tracer_step"]
