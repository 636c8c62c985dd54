"""The full model step in field form: dynamics, hyperviscosity, tracers
(counterpart of ``tinman_sandbox_tpu/timeloop/prim.py``).

One step in HOMME's prim_run cadence:

  1. dynamics: SSPRK3 on the CAAR tendencies with a DSS projection per
     stage (``timeloop.rk``);
  2. biharmonic hyperviscosity on the updated (np1) state
     (``timeloop.hyperviscosity``);
  3. tracer transport: ``qsplit`` SSPRK3 substeps at dt/qsplit advected by
     the np1 winds (``timeloop.tracer``);
  4. time-level rotation.

This is the oracle that the packed step ``dist.step_t.prim_step_packed_t4``
is held against. The vertical remap of the JAX package's step is not ported
yet: ``remap=True`` raises.
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord
from ..state import Derived, State
from .driver import rotated
from .hyperviscosity import apply_hyperviscosity
from .rk import ssprk3_step
from .tracer import ssprk3_tracer_step

__all__ = ["prim_run_step", "air_mass"]


def air_mass(state: State, spheremp, cfg: Config):
    """spheremp-weighted global air mass of dp3d at np1, in the state's
    dtype and a fixed summation order: the mass fixer's functional (use it
    for both the target and the current mass, so its bias cancels in the
    ratio)."""
    return (spheremp[:, None] * state.dp3d[cfg.np1]).sum()


def prim_run_step(state: State, derived: Derived, geom: Geometry,
                  hv: HybridVCoord, cfg: Config, gdof, ndof: int,
                  nu: float = 0.0, qsplit: int = 1, moist: bool = True,
                  limit_tracers: bool = False, remap: bool = False,
                  rsp2=None, device="cuda"):
    """One full model step of length cfg.dt. Returns (state, derived, cfg)
    on ``device``, cfg carrying the rotated time-level indices (qn0 flips
    with the dynamics rotation). ``limit_tracers`` applies the monotone
    mass-conserving limiter inside every tracer substage; ``rsp2`` is the
    optional two-float rspheremp pair. The inputs are not modified."""
    if remap:
        raise NotImplementedError(
            "prim_run_step(remap=True) is not yet ported: the vertical "
            "remap (ops/remap.py beyond comp_sum) is still to come")
    dev = resolve_device(device)
    state, derived = state.to(dev), derived.to(dev)
    geom, hv = geom.to(dev), hv.to(dev)
    state, derived = ssprk3_step(state, derived, geom, hv, cfg, cfg.dt,
                                 gdof=gdof, ndof=ndof, moist=moist,
                                 rsp2=rsp2, device=dev)
    if nu:
        state = apply_hyperviscosity(state, geom, gdof, ndof, cfg, nu=nu,
                                     dt=cfg.dt, device=dev)
    # tracers ride the updated winds, subcycled for CFL
    nsub = max(qsplit, 1)
    qdp = state.qdp[cfg.qn0]
    vu, vv = state.u[cfg.np1], state.v[cfg.np1]
    for _ in range(nsub):
        qdp = ssprk3_tracer_step(qdp, vu, vv, geom, cfg, cfg.dt / nsub,
                                 gdof=gdof, ndof=ndof, limit=limit_tracers,
                                 rsp2=rsp2)
    new_qdp = state.qdp.clone()
    new_qdp[1 - cfg.qn0] = qdp
    state = dataclasses.replace(state, qdp=new_qdp)
    return state, derived, dataclasses.replace(rotated(cfg),
                                               qn0=1 - cfg.qn0)
