"""compute_and_apply_rhs in array form (counterpart of
``tinman_sandbox_tpu/kernels/caar_xla.py``): the vertically Lagrangian
rsplit>0 step and the full eta-coordinate rsplit=0 step.

Batched over the field layout [nelem, nlev, np, np] and built from the ops/
layer. Works in any float dtype (f64 for the oracle gate, f32 for the fast
path); it is the port's oracle-comparable path.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..constants import CONSTANTS
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord
from ..ops import (
    divergence_sphere,
    eta_dot_dpdn_rsplit0,
    gradient_sphere,
    midpoint_pressure,
    preq_hydrostatic,
    preq_omega_ps,
    preq_vertadv,
    virtual_temperature,
    vorticity_sphere,
)
from ..state import Derived, State

__all__ = ["caar_rhs", "caar_array", "level_terms", "tendencies",
           "leapfrog_update"]


def level_terms(u, v, t, dp, qdp_q, p, geom: Geometry, moist: bool = True):
    """The level-local terms of ``caar_rhs`` once the midpoint pressure p is
    known: (grad_p1, grad_p2, vgrad_p, vdp1, vdp2, divdp, vort, t_v)."""
    c = CONSTANTS
    dvv = geom.dvv
    dinv = geom.dinv[:, None]
    rr = c.rrearth
    grad_p1, grad_p2 = gradient_sphere(p, dvv, dinv, rr)
    vgrad_p = u * grad_p1 + v * grad_p2
    vdp1, vdp2 = u * dp, v * dp

    divdp = divergence_sphere(vdp1, vdp2, dvv, dinv, geom.metdet[:, None],
                              geom.rmetdet[:, None], rr)
    vort = vorticity_sphere(u, v, dvv, geom.d[:, None], geom.rmetdet[:, None],
                            rr)

    t_v = virtual_temperature(t, qdp_q, dp, c.rgas_over_rvap_m1) if moist \
        else t
    return grad_p1, grad_p2, vgrad_p, vdp1, vdp2, divdp, vort, t_v


def tendencies(u, v, t, p, phi, pecnd, t_v, omega_p, grad_p1, grad_p2,
               vort, divdp, geom: Geometry, vadv=None, d_eta_int=0.0):
    """The level-local tendencies of ``caar_rhs`` from the column terms:
    (vtens1, vtens2, ttens, dptens); ``vadv`` is (t_vadv, u_vadv, v_vadv),
    None for zero (rsplit>0)."""
    c = CONSTANTS
    dvv = geom.dvv
    dinv = geom.dinv[:, None]
    rr = c.rrearth
    t_vadv, u_vadv, v_vadv = vadv if vadv is not None else \
        (torch.zeros_like(t),) * 3
    ephi = 0.5 * (u * u + v * v) + phi + pecnd
    grad_t1, grad_t2 = gradient_sphere(t, dvv, dinv, rr)
    vgrad_t = u * grad_t1 + v * grad_t2
    gephi1, gephi2 = gradient_sphere(ephi, dvv, dinv, rr)
    gpterm = c.Rgas * (t_v / p)
    fcor_vort = geom.fcor[:, None] + vort
    vtens1 = -u_vadv + v * fcor_vort - gephi1 - gpterm * grad_p1
    vtens2 = -v_vadv - (u * fcor_vort) - gephi2 - gpterm * grad_p2
    ttens = -t_vadv - vgrad_t + c.kappa * t_v * omega_p
    dptens = -(divdp + d_eta_int)
    return vtens1, vtens2, ttens, dptens


def caar_rhs(u, v, t, dp, qdp_q, phis, pecnd, geom: Geometry,
             hv: HybridVCoord, cfg: Config, moist: bool = True):
    """CAAR tendencies at one time level (routine_mod.F90:7-177). Returns
    (vtens1, vtens2, ttens, dptens, diags) with dptens = -(divdp + delta_k
    eta_dot_dpdn) and diags carrying phi / omega_p / vdp1 / vdp2 /
    eta_dot_dpdn (zero for rsplit>0). Every term but the vertical scans
    is level-local (``level_terms``, ``tendencies``): the level-sharded
    step (``dist/level_sharded.py``) runs the same two with its carries."""
    c = CONSTANTS
    p = midpoint_pressure(hv.hyai[0] * hv.ps0, dp)
    grad_p1, grad_p2, vgrad_p, vdp1, vdp2, divdp, vort, t_v = level_terms(
        u, v, t, dp, qdp_q, p, geom, moist)

    phi = preq_hydrostatic(phis, t_v, p, dp, c.Rgas)
    omega_p = preq_omega_ps(p, vgrad_p, divdp)

    # rsplit>0 is vertically Lagrangian (eta_dot_dpdn = vertical advection
    # = 0, routine_mod.F90:121-124); rsplit=0 is the full eta-coordinate
    # path (routine_extracted.F90:224-260)
    nelem, nlev = t.shape[0], t.shape[1]
    if cfg.rsplit > 0:
        vadv = None
        eta_dot = torch.zeros((nelem, nlev + 1) + tuple(t.shape[2:]),
                              dtype=t.dtype, device=t.device)
        d_eta_int = 0.0
    else:
        eta_dot, _ = eta_dot_dpdn_rsplit0(divdp, hv.hybi)
        vadv = preq_vertadv(t, u, v, eta_dot, 1.0 / dp)
        d_eta_int = eta_dot[:, 1:] - eta_dot[:, :-1]

    vtens1, vtens2, ttens, dptens = tendencies(
        u, v, t, p, phi, pecnd, t_v, omega_p, grad_p1, grad_p2, vort, divdp,
        geom, vadv, d_eta_int)
    diags = dict(phi=phi, omega_p=omega_p, vdp1=vdp1, vdp2=vdp2,
                 eta_dot_dpdn=eta_dot)
    return vtens1, vtens2, ttens, dptens, diags


def caar_array(state: State, derived: Derived, geom: Geometry,
               hv: HybridVCoord, cfg: Config, dt2, eta_ave_w,
               moist: bool = True, device="cuda"):
    """One CAAR evaluation + leapfrog update on ``device``, rsplit>0 or
    rsplit=0 (dp3d with the interface-flux stencil, routine_extracted.F90:
    517, and the eta_dot_dpdn accumulator). Returns (new_state,
    new_derived); the inputs are not modified."""
    dev = resolve_device(device)
    state, derived = state.to(dev), derived.to(dev)
    geom, hv = geom.to(dev), hv.to(dev)
    n0, qn0 = cfg.n0, cfg.qn0

    *tend, diags = caar_rhs(
        state.u[n0], state.v[n0], state.t[n0], state.dp3d[n0],
        state.qdp[qn0, :, 0] if moist else None,
        state.phis, derived.pecnd, geom, hv, cfg, moist=moist,
    )
    return leapfrog_update(state, derived, tend, diags, geom, cfg, dt2,
                           eta_ave_w)


def leapfrog_update(state: State, derived: Derived, tend, diags,
                    geom: Geometry, cfg: Config, dt2, eta_ave_w):
    """``caar_array``'s update from the tendencies ``tend`` (vtens1,
    vtens2, ttens, dptens) and ``caar_rhs``'s diags: np1 = spheremp *
    (nm1 + dt2 * tendency), the accumulators advanced by eta_ave_w.
    Returns (new_state, new_derived); the inputs are not modified."""
    dt2, eta_ave_w = float(dt2), float(eta_ave_w)
    np1, nm1 = cfg.np1, cfg.nm1
    sph = geom.spheremp[:, None]

    def put(x, tendency):
        out = x.clone()
        out[np1] = sph * (x[nm1] + dt2 * tendency)
        return out

    vtens1, vtens2, ttens, dptens = tend
    new_state = dataclasses.replace(
        state,
        u=put(state.u, vtens1),
        v=put(state.v, vtens2),
        t=put(state.t, ttens),
        dp3d=put(state.dp3d, dptens),
    )
    new_derived = dataclasses.replace(
        derived,
        vn0_u=derived.vn0_u + eta_ave_w * diags["vdp1"],
        vn0_v=derived.vn0_v + eta_ave_w * diags["vdp2"],
        phi=diags["phi"],
        omega_p=derived.omega_p + eta_ave_w * diags["omega_p"],
        eta_dot_dpdn=derived.eta_dot_dpdn + eta_ave_w * diags["eta_dot_dpdn"],
    )
    return new_state, new_derived
