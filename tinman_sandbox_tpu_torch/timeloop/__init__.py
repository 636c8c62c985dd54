"""Time integration (counterpart of ``tinman_sandbox_tpu/timeloop``): the
leapfrog loop, the SSPRK3 step, biharmonic hyperviscosity, the tracer step,
the full model step (with the vertical remap and the mass fixer), the npz
checkpoints and the non-blocking directory checkpoints."""
from .checkpoint import (
    checkpoint_meta,
    finish_async_checkpoints,
    load_checkpoint,
    load_checkpoint_dir,
    load_packed_checkpoint,
    save_checkpoint,
    save_checkpoint_dir,
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
           "euler_step", "finish_async_checkpoints",
           "leapfrog_step", "load_checkpoint", "load_checkpoint_dir",
           "load_packed_checkpoint", "prim_run_step", "rotated",
           "run_leapfrog", "save_checkpoint", "save_checkpoint_dir",
           "save_packed_checkpoint", "ssprk3_step", "ssprk3_tracer_step"]
