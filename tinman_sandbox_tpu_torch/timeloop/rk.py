"""Runge-Kutta time integration on the CAAR right-hand side (counterpart of
``tinman_sandbox_tpu/timeloop/rk.py``).

Strong-stability-preserving RK3 in Shu-Osher form on the factored
tendencies ``kernels.caar_array.caar_rhs``:

    U1 = P(U0 + dt L(U0))
    U2 = P(3/4 U0 + 1/4 (U1 + dt L(U1)))
    U3 = P(1/3 U0 + 2/3 (U2 + dt L(U2)))

with P the continuous (DSS) projection after every stage when a dof map is
given, and the mean-flux accumulators weighted by the scheme's effective
quadrature b = (1/6, 1/6, 2/3). This is the field-form oracle that the
packed step ``dist.step_t.ssprk3_packed_t4`` is held against.
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord
from ..kernels.caar_array import caar_rhs
from ..state import Derived, State

__all__ = ["ssprk3_step", "B_WEIGHTS", "third_stage_weights"]

B_WEIGHTS = (1.0 / 6.0, 1.0 / 6.0, 2.0 / 3.0)


def third_stage_weights(f):
    """The last stage's Shu-Osher pair (1/3, 2/3) as numbers of the scalar
    type ``f`` (np.float32 or np.float64) that add up to exactly 1:
    (1 - f(2/3), f(2/3)). Each rounded on its own, both float32 values lie
    above 1/3 and 2/3 and the pair adds 2**-25 of the stage's input every
    step, a linear drift of the tracer and air mass of ~3e-8 a step."""
    b = f(2.0 / 3.0)
    return f(1.0) - b, b


def _project(fields, geom, gdof, ndof, rsp2=None):
    if gdof is None:
        return fields
    from ..dist.dss import dss_project

    rsp = rsp2 if rsp2 is not None else geom.rspheremp
    return tuple(dss_project(x, gdof, ndof, geom.spheremp, rsp)
                 for x in fields)


def ssprk3_step(state: State, derived: Derived, geom: Geometry,
                hv: HybridVCoord, cfg: Config, dt, gdof=None, ndof: int = 0,
                moist: bool = True, rsp2=None, device="cuda"):
    """One SSPRK3 step of (u, v, T, dp3d), written to time level np1.

    Tracers (qdp) are held fixed. ``rsp2`` is an optional two-float
    (hi, lo) rspheremp pair (``dist.dss.rsp_2f``) for bias-free projection.
    phi is the last stage's. Returns (state, derived) on ``device``; the
    inputs are not modified."""
    if cfg.rsplit <= 0:
        raise NotImplementedError("ssprk3_step ports the rsplit>0 path only")
    dev = resolve_device(device)
    state, derived = state.to(dev), derived.to(dev)
    geom, hv = geom.to(dev), hv.to(dev)
    n0, np1, qn0 = cfg.n0, cfg.np1, cfg.qn0
    dt = float(dt)
    qdp_q = state.qdp[qn0, :, 0] if moist else None
    u0 = (state.u[n0], state.v[n0], state.t[n0], state.dp3d[n0])

    def rhs(fields):
        return caar_rhs(*fields, qdp_q, state.phis, derived.pecnd, geom, hv,
                        cfg, moist=moist)

    def axpy(a, x, b, y):
        return tuple(a * xi + b * yi for xi, yi in zip(x, y))

    acc = {"vdp1": 0.0, "vdp2": 0.0, "omega_p": 0.0}

    def accumulate(diags, w):
        for name in acc:
            acc[name] = acc[name] + w * diags[name]

    # stage 1
    t1 = rhs(u0)
    accumulate(t1[4], B_WEIGHTS[0])
    u1 = _project(axpy(1.0, u0, dt, t1[:4]), geom, gdof, ndof, rsp2)
    # stage 2
    t2 = rhs(u1)
    accumulate(t2[4], B_WEIGHTS[1])
    u2 = _project(axpy(0.75, u0, 0.25, axpy(1.0, u1, dt, t2[:4])), geom,
                  gdof, ndof, rsp2)
    # stage 3
    t3 = rhs(u2)
    accumulate(t3[4], B_WEIGHTS[2])
    u3 = _project(axpy(1.0 / 3.0, u0, 2.0 / 3.0, axpy(1.0, u2, dt, t3[:4])),
                  geom, gdof, ndof, rsp2)

    def put(x, new):
        out = x.clone()
        out[np1] = new
        return out

    new_state = dataclasses.replace(
        state, u=put(state.u, u3[0]), v=put(state.v, u3[1]),
        t=put(state.t, u3[2]), dp3d=put(state.dp3d, u3[3]))
    # rsplit>0 is vertically Lagrangian: eta_dot_dpdn gets no increment
    new_derived = dataclasses.replace(
        derived,
        vn0_u=derived.vn0_u + acc["vdp1"],
        vn0_v=derived.vn0_v + acc["vdp2"],
        omega_p=derived.omega_p + acc["omega_p"],
        eta_dot_dpdn=derived.eta_dot_dpdn.clone(),
        phi=t3[4]["phi"])
    return new_state, new_derived
