"""Tracer advection in field form (counterpart of
``tinman_sandbox_tpu/timeloop/tracer.py``).

For every tracer q, qdp_out = qdp - dt * div(vstar * qdp) through the fused
divergence update (EulerStepFunctor.hpp:33-69, SphereOperators.hpp:362-403),
batched over [nelem, qsize, nlev, np, np]; and the SSPRK3 tracer step with
the optional monotone limiter and the continuous projection per stage. This
is the oracle that the packed step ``dist.step_t.ssprk3_tracer_packed_t``
is held against.
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..constants import CONSTANTS
from ..grid import Geometry
from ..ops.limiter import element_bounds, limit_tracer
from ..ops.sphere import divergence_sphere_update
from ..state import State

__all__ = ["euler_step", "advance_qdp", "ssprk3_tracer_step"]


def euler_step(qdp, vstar_u, vstar_v, geom: Geometry, cfg: Config, dt):
    """qdp - dt*div(vstar*qdp) for all tracers at once. qdp
    [nelem, qsize, nlev, np, np]; vstar_u, vstar_v [nelem, nlev, np, np]."""
    # element geometry broadcast over (qsize, nlev)
    dinv = geom.dinv[:, None, None]
    metdet = geom.metdet[:, None, None]
    rmetdet = geom.rmetdet[:, None, None]
    return divergence_sphere_update(
        vstar_u[:, None] * qdp, vstar_v[:, None] * qdp, -dt, 1.0, qdp,
        geom.dvv, dinv, metdet, rmetdet, CONSTANTS.rrearth)


def advance_qdp(state: State, geom: Geometry, cfg: Config, dt) -> State:
    """Full-state tracer step: reads qdp[qn0] and the n0 winds, writes the
    other qdp time level (1 - qn0). The input is not modified."""
    new = euler_step(state.qdp[cfg.qn0], state.u[cfg.n0], state.v[cfg.n0],
                     geom, cfg, dt)
    qdp = state.qdp.clone()
    qdp[1 - cfg.qn0] = new
    return dataclasses.replace(state, qdp=qdp)


def ssprk3_tracer_step(qdp, vstar_u, vstar_v, geom: Geometry, cfg: Config,
                       dt, gdof=None, ndof: int = 0, limit: bool = False,
                       rsp2=None):
    """SSPRK3 tracer transport. Each stage is the Euler step, optionally
    the monotone mass-conserving limiter (``ops.limiter``, bounds from the
    stage's input extrema), then the continuous (DSS) projection when a dof
    map is given: per stage P(L(combination, bounds(q_in))). ``rsp2`` is the
    optional two-float rspheremp pair (``dist.dss.rsp_2f``). Runs on the
    device of its operands."""
    if gdof is not None:
        from ..dist.dss import dss_project

        rsp = rsp2 if rsp2 is not None else geom.rspheremp

        def P(q):
            return dss_project(q, gdof, ndof, geom.spheremp, rsp)
    else:
        def P(q):
            return q
    if limit:
        w = geom.spheremp[:, None, None]

        def L(q_out, q_in):
            return limit_tracer(q_out, w, *element_bounds(q_in))
    else:
        def L(q_out, q_in):
            return q_out

    def E(q):
        return euler_step(q, vstar_u, vstar_v, geom, cfg, dt)

    q1 = P(L(E(qdp), qdp))
    q2 = P(L(0.75 * qdp + 0.25 * E(q1), q1))
    return P(L(qdp / 3.0 + (2.0 / 3.0) * E(q2), q2))
