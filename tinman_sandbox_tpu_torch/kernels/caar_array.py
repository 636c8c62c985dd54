"""compute_and_apply_rhs in array form (counterpart of
``tinman_sandbox_tpu/kernels/caar_xla.py``, rsplit>0 only).

Batched over the field layout [nelem, nlev, np, np] and built from the ops/
layer. Works in any float dtype (f64 for the oracle gate, f32 for the fast
path); it is the port's oracle-comparable path.
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..constants import CONSTANTS
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord
from ..ops import (
    divergence_sphere,
    gradient_sphere,
    midpoint_pressure,
    preq_hydrostatic,
    preq_omega_ps,
    virtual_temperature,
    vorticity_sphere,
)
from ..state import Derived, State

__all__ = ["caar_rhs", "caar_array"]


def caar_rhs(u, v, t, dp, qdp_q, phis, pecnd, geom: Geometry,
             hv: HybridVCoord, moist: bool = True):
    """CAAR tendencies at one time level, rsplit>0 (routine_mod.F90:7-177).
    Returns (vtens1, vtens2, ttens, dptens, diags) with dptens = -divdp and
    diags carrying phi / omega_p / vdp1 / vdp2."""
    c = CONSTANTS
    dvv = geom.dvv
    dinv = geom.dinv[:, None]
    d = geom.d[:, None]
    metdet = geom.metdet[:, None]
    rmetdet = geom.rmetdet[:, None]
    fcor = geom.fcor[:, None]
    rr = c.rrearth

    p = midpoint_pressure(hv.hyai[0] * hv.ps0, dp)
    grad_p1, grad_p2 = gradient_sphere(p, dvv, dinv, rr)
    vgrad_p = u * grad_p1 + v * grad_p2
    vdp1, vdp2 = u * dp, v * dp

    divdp = divergence_sphere(vdp1, vdp2, dvv, dinv, metdet, rmetdet, rr)
    vort = vorticity_sphere(u, v, dvv, d, rmetdet, rr)

    t_v = virtual_temperature(t, qdp_q, dp, c.rgas_over_rvap_m1) if moist \
        else t

    phi = preq_hydrostatic(phis, t_v, p, dp, c.Rgas)
    omega_p = preq_omega_ps(p, vgrad_p, divdp)

    # rsplit>0 is vertically Lagrangian: no vertical advection terms
    ephi = 0.5 * (u * u + v * v) + phi + pecnd
    grad_t1, grad_t2 = gradient_sphere(t, dvv, dinv, rr)
    vgrad_t = u * grad_t1 + v * grad_t2
    gephi1, gephi2 = gradient_sphere(ephi, dvv, dinv, rr)
    gpterm = c.Rgas * (t_v / p)
    fcor_vort = fcor + vort
    vtens1 = v * fcor_vort - gephi1 - gpterm * grad_p1
    vtens2 = -(u * fcor_vort) - gephi2 - gpterm * grad_p2
    ttens = -vgrad_t + c.kappa * t_v * omega_p
    dptens = -divdp

    diags = dict(phi=phi, omega_p=omega_p, vdp1=vdp1, vdp2=vdp2)
    return vtens1, vtens2, ttens, dptens, diags


def caar_array(state: State, derived: Derived, geom: Geometry,
               hv: HybridVCoord, cfg: Config, dt2, eta_ave_w,
               moist: bool = True, device="cuda"):
    """One CAAR evaluation + leapfrog update on ``device``. Returns
    (new_state, new_derived); the inputs are not modified."""
    if cfg.rsplit <= 0:
        raise NotImplementedError(
            "caar_array ports the rsplit>0 path only; rsplit=0 is not yet "
            "ported")
    dev = resolve_device(device)
    state, derived = state.to(dev), derived.to(dev)
    geom, hv = geom.to(dev), hv.to(dev)
    dt2, eta_ave_w = float(dt2), float(eta_ave_w)
    n0, np1, nm1, qn0 = cfg.n0, cfg.np1, cfg.nm1, cfg.qn0
    sph = geom.spheremp[:, None]

    vtens1, vtens2, ttens, dptens, diags = caar_rhs(
        state.u[n0], state.v[n0], state.t[n0], state.dp3d[n0],
        state.qdp[qn0, :, 0] if moist else None,
        state.phis, derived.pecnd, geom, hv, moist=moist,
    )

    def put(x, new):
        out = x.clone()
        out[np1] = new
        return out

    new_state = dataclasses.replace(
        state,
        u=put(state.u, sph * (state.u[nm1] + dt2 * vtens1)),
        v=put(state.v, sph * (state.v[nm1] + dt2 * vtens2)),
        t=put(state.t, sph * (state.t[nm1] + dt2 * ttens)),
        dp3d=put(state.dp3d, sph * (state.dp3d[nm1] + dt2 * dptens)),
    )
    new_derived = dataclasses.replace(
        derived,
        vn0_u=derived.vn0_u + eta_ave_w * diags["vdp1"],
        vn0_v=derived.vn0_v + eta_ave_w * diags["vdp2"],
        phi=diags["phi"],
        omega_p=derived.omega_p + eta_ave_w * diags["omega_p"],
        eta_dot_dpdn=derived.eta_dot_dpdn.clone(),
    )
    return new_state, new_derived
