"""Biharmonic hyperviscosity step in field form (counterpart of
``tinman_sandbox_tpu/timeloop/hyperviscosity.py``).

Two weak-form Laplacian applications with DSS assembly between (the weak
operator produces spheremp-weighted residuals, so each pass is closed by
rspheremp * DSS), then the explicit update

    X <- X - dt * nu * grad^4(X)        (u, v, T)

subcycled ``subcycle`` times per step. This is the oracle that the packed
step ``dist.step_t.apply_hypervis_packed_t`` is held against.
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..constants import CONSTANTS
from ..device import resolve_device
from ..dist.dss import dss_scaled
from ..grid import Geometry
from ..ops import laplace_simple, vlaplace_sphere_wk_contra
from ..state import State

__all__ = ["biharmonic_wk", "apply_hyperviscosity"]


def biharmonic_wk(u, v, t, geom: Geometry, gdof, ndof: int, nu_ratio=1.0):
    """Assembled grad^4 of (u, v) [vector] and t [scalar]: two (weak
    laplacian -> rspheremp*DSS) passes."""
    dvv = geom.dvv
    dinv = geom.dinv[:, None]
    d = geom.d[:, None]
    sph = geom.spheremp[:, None]
    mp = geom.mp[:, None]
    metinv = geom.metinv[:, None]
    metdet = geom.metdet[:, None]
    rmetdet = geom.rmetdet[:, None]
    rr = CONSTANTS.rrearth
    rsp = geom.rspheremp

    def vec_lap(a, b):
        l1, l2 = vlaplace_sphere_wk_contra(
            a, b, dvv, d, dinv, mp, sph, metinv, metdet, rmetdet, rr, nu_ratio)
        return (dss_scaled(l1, gdof, ndof, rsp),
                dss_scaled(l2, gdof, ndof, rsp))

    def sca_lap(s):
        return dss_scaled(laplace_simple(s, dvv, dinv, sph, rr), gdof, ndof,
                          rsp)

    lu, lv = vec_lap(u, v)
    lt = sca_lap(t)
    return (*vec_lap(lu, lv), sca_lap(lt))


def apply_hyperviscosity(state: State, geom: Geometry, gdof, ndof: int,
                         cfg: Config, nu, nu_div_ratio=1.0, dt=None,
                         subcycle: int = 1, device="cuda"):
    """Damp the np1 time level: X -= (dt/subcycle)*nu*grad^4(X). Returns the
    new state on ``device``; the input is not modified."""
    dev = resolve_device(device)
    state, geom = state.to(dev), geom.to(dev)
    np1 = cfg.np1
    dt = cfg.dt if dt is None else dt
    dt_sub, nu = float(dt) / subcycle, float(nu)

    u, v, t = state.u[np1], state.v[np1], state.t[np1]
    for _ in range(subcycle):
        b_u, b_v, b_t = biharmonic_wk(u, v, t, geom, gdof, ndof, nu_div_ratio)
        u = u - dt_sub * nu * b_u
        v = v - dt_sub * nu * b_v
        t = t - dt_sub * nu * b_t

    def put(x, new):
        out = x.clone()
        out[np1] = new
        return out

    return dataclasses.replace(state, u=put(state.u, u), v=put(state.v, v),
                               t=put(state.t, t))
