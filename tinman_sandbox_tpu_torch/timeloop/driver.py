"""Time-integration drivers (counterpart of
``tinman_sandbox_tpu/timeloop/driver.py``).

  * the golden benchmark loop — CAAR calls at FIXED time-level indices
    (fortran/main.F90:201-210), as a Python loop;
  * a leapfrog driver with cyclic time-level rotation (utils_mod.F90:35-41:
    nm1 <- n0, n0 <- np1, np1 <- old nm1);
  * the dp3d>0 runtime invariant (CaarFunctor.hpp:85-96).
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..device import resolve_device
from ..kernels.caar_array import caar_array
from ..state import State

__all__ = ["benchmark_loop", "rotated", "leapfrog_step", "run_leapfrog",
           "check_dp3d"]


def benchmark_loop(state, derived, geom, hv, cfg: Config, dt2, eta_ave_w,
                   nsteps: int, moist: bool = True, device="cuda"):
    """``nsteps`` array-form CAAR evaluations at fixed time-level indices —
    the golden workload (main.F90:201-210)."""
    dev = resolve_device(device)
    for _ in range(nsteps):
        state, derived = caar_array(state, derived, geom, hv, cfg, dt2,
                                    eta_ave_w, moist=moist, device=dev)
    return state, derived


def rotated(cfg: Config) -> Config:
    """Leapfrog time-level rotation (utils_mod.F90:35-41)."""
    return dataclasses.replace(cfg, nm1=cfg.n0, n0=cfg.np1, np1=cfg.nm1)


def leapfrog_step(state, derived, geom, hv, cfg, dt2, eta_ave_w, moist=True,
                  device="cuda"):
    """One CAAR update followed by time-level rotation. Returns
    (state, derived, cfg) where cfg carries the rotated indices."""
    state, derived = caar_array(state, derived, geom, hv, cfg, dt2,
                                eta_ave_w, moist=moist, device=device)
    return state, derived, rotated(cfg)


def run_leapfrog(state, derived, geom, hv, cfg, nsteps=None, moist=True,
                 device="cuda"):
    """Drive ``nsteps`` array-form leapfrog steps with time-level rotation:
    dt2 = 2*dt, eta_ave_w = 1/nsteps."""
    nsteps = cfg.nsteps if nsteps is None else nsteps
    dt2 = 2.0 * cfg.dt
    eta_ave_w = 1.0 / max(nsteps, 1)
    for _ in range(nsteps):
        state, derived, cfg = leapfrog_step(
            state, derived, geom, hv, cfg, dt2, eta_ave_w, moist=moist,
            device=device)
    return state, derived, cfg


def check_dp3d(state: State, cfg: Config):
    """dp3d>0 invariant at the just-updated time level. Returns
    (all_positive, min_value) as Python values."""
    dp = state.dp3d[cfg.np1]
    return bool((dp > 0.0).all()), float(dp.min())
