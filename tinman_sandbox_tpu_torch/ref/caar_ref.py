"""Float64 oracle for compute_and_apply_rhs (CAAR), in torch
(counterpart of ``tinman_sandbox_tpu/ref/caar_ref.py``).

Behavioral mirror of the reference's golden Fortran kernel
(fortran/routine_mod.F90:7-293), vectorized over elements/levels/GLL points
but keeping Fortran's order of floating-point operations (explicitly
unrolled 4-term Dvv contractions, sequential cumulative sums), so results
match the golden arrays in test_mod.F90 to the last bit or near it. Run it
in float64; the golden gate is this module's correctness anchor.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..constants import CONSTANTS
from ..grid import Geometry, HybridVCoord
from ..state import Derived, State

__all__ = ["caar_ref"]


def _dvv_contract_x(dvv, s):
    """ds/dx[..., l, j] = sum_i Dvv[i, l] * s[..., i, j], with the reference's
    left-to-right 4-term accumulation (derivative_mod_base.F90:44-55)."""
    acc = dvv[0][:, None] * s[..., 0, :][..., None, :]
    for i in range(1, 4):
        acc = acc + dvv[i][:, None] * s[..., i, :][..., None, :]
    return acc


def _dvv_contract_y(dvv, s):
    """ds/dy[..., j, l] = sum_i Dvv[i, l] * s[..., j, i] (axis-1 derivative)."""
    acc = dvv[0][None, :] * s[..., :, 0][..., :, None]
    for i in range(1, 4):
        acc = acc + dvv[i][None, :] * s[..., :, i][..., :, None]
    return acc


def gradient_sphere_ref(s, dvv, dinv, rrearth):
    """gradient_sphere (derivative_mod_base.F90:25-65)."""
    v1 = _dvv_contract_x(dvv, s) * rrearth
    v2 = _dvv_contract_y(dvv, s) * rrearth
    ds1 = dinv[..., 0, 0, :, :] * v1 + dinv[..., 1, 0, :, :] * v2
    ds2 = dinv[..., 0, 1, :, :] * v1 + dinv[..., 1, 1, :, :] * v2
    return ds1, ds2


def divergence_sphere_ref(v1, v2, dvv, dinv, metdet, rmetdet, rrearth):
    """divergence_sphere (derivative_mod_base.F90:182-230)."""
    gv1 = metdet * (dinv[..., 0, 0, :, :] * v1 + dinv[..., 0, 1, :, :] * v2)
    gv2 = metdet * (dinv[..., 1, 0, :, :] * v1 + dinv[..., 1, 1, :, :] * v2)
    dudx = _dvv_contract_x(dvv, gv1)
    dvdy = _dvv_contract_y(dvv, gv2)
    return (dudx + dvdy) * (rmetdet * rrearth)


def vorticity_ref(u, v, dvv, d, rmetdet, rrearth):
    """vorticity_v2 (derivative_mod_base.F90:127-177)."""
    vco1 = d[..., 0, 0, :, :] * u + d[..., 1, 0, :, :] * v
    vco2 = d[..., 0, 1, :, :] * u + d[..., 1, 1, :, :] * v
    dvdx = _dvv_contract_x(dvv, vco2)
    dudy = _dvv_contract_y(dvv, vco1)
    return (dvdx - dudy) * (rmetdet * rrearth)


def preq_hydrostatic_ref(phis, t_v, p, dp, rgas):
    """preq_hydrostatic (routine_mod.F90:255-293): reverse vertical scan.
    Level axis is -3 ([..., nlev, np, np])."""
    hkk = dp * 0.5 / p
    term_full = rgas * t_v * (2.0 * hkk)
    term_half = rgas * t_v * hkk
    phii = torch.flip(torch.cumsum(torch.flip(term_full, (-3,)), dim=-3),
                      (-3,))
    phii_below = torch.cat(
        [phii[..., 1:, :, :], torch.zeros_like(phii[..., :1, :, :])], dim=-3)
    return phis[..., None, :, :] + phii_below + term_half


def preq_omega_ps_ref(p, vgrad_p, divdp):
    """preq_omega_ps (routine_mod.F90:207-252): forward scan."""
    ckk = 0.5 / p
    ckl = 2.0 * ckk
    csum = torch.cumsum(divdp, dim=-3)
    suml_prev = torch.cat(
        [torch.zeros_like(csum[..., :1, :, :]), csum[..., :-1, :, :]], dim=-3)
    return (vgrad_p / p - ckl * suml_prev) - ckk * divdp


def midpoint_pressure_ref(hyai0_ps0, dp):
    """Midpoint pressure scan (routine_mod.F90:72-75) with Fortran's
    left-to-right grouping reproduced via an interleaved cumsum."""
    half = dp / 2.0
    a = half[..., :-1, :, :]
    b = half[..., 1:, :, :]
    inter = torch.stack([a, b], dim=-3)
    inter = inter.reshape(*inter.shape[:-4], -1, *inter.shape[-2:])
    p0 = hyai0_ps0 + half[..., :1, :, :]
    cs = torch.cumsum(torch.cat([p0, inter], dim=-3), dim=-3)
    return cs[..., 0::2, :, :]


def caar_ref(state: State, derived: Derived, geom: Geometry,
             hv: HybridVCoord, cfg: Config, dt2: float = 1.0,
             eta_ave_w: float = 1.0, moist: bool = True):
    """One CAAR evaluation + state update (routine_mod.F90:7-193) on the
    tensors' own device. Mutates nothing; returns (new State, new Derived)."""
    c = CONSTANTS
    n0, np1, nm1, qn0 = cfg.n0, cfg.np1, cfg.nm1, cfg.qn0
    dvv = geom.dvv
    dinv = geom.dinv[:, None]
    d = geom.d[:, None]
    metdet = geom.metdet[:, None]
    rmetdet = geom.rmetdet[:, None]
    rr = c.rrearth

    u, v = state.u[n0], state.v[n0]
    t, dp = state.t[n0], state.dp3d[n0]

    p = midpoint_pressure_ref(float(hv.hyai[0]) * hv.ps0, dp)

    grad_p1, grad_p2 = gradient_sphere_ref(p, dvv, dinv, rr)
    vgrad_p = u * grad_p1 + v * grad_p2
    vdp1 = u * dp
    vdp2 = v * dp
    vn0_u = derived.vn0_u + eta_ave_w * vdp1
    vn0_v = derived.vn0_v + eta_ave_w * vdp2

    divdp = divergence_sphere_ref(vdp1, vdp2, dvv, dinv, metdet, rmetdet, rr)
    vort = vorticity_ref(u, v, dvv, d, rmetdet, rr)

    if moist:
        qt = state.qdp[qn0, :, 0] / dp
        t_v = t * (1.0 + (c.Rwater_vapor / c.Rgas - 1.0) * qt)
    else:
        t_v = t.clone()

    phi = preq_hydrostatic_ref(state.phis, t_v, p, dp, c.Rgas)
    omega_p = preq_omega_ps_ref(p, vgrad_p, divdp)

    d_omega_p = derived.omega_p + eta_ave_w * omega_p

    e_kin = 0.5 * (u * u + v * v)
    ephi = e_kin + phi + derived.pecnd
    grad_t1, grad_t2 = gradient_sphere_ref(t, dvv, dinv, rr)
    vgrad_t = u * grad_t1 + v * grad_t2
    gephi1, gephi2 = gradient_sphere_ref(ephi, dvv, dinv, rr)
    gpterm = t_v / p
    glnps1 = c.Rgas * gpterm * grad_p1
    glnps2 = c.Rgas * gpterm * grad_p2
    fcor_vort = geom.fcor[:, None] + vort
    vtens1 = v * fcor_vort - gephi1 - glnps1
    vtens2 = -(u * fcor_vort) - gephi2 - glnps2
    ttens = -vgrad_t + c.kappa * t_v * omega_p

    sph = geom.spheremp[:, None]
    new_u, new_v = state.u.clone(), state.v.clone()
    new_t, new_dp = state.t.clone(), state.dp3d.clone()
    new_u[np1] = sph * (state.u[nm1] + dt2 * vtens1)
    new_v[np1] = sph * (state.v[nm1] + dt2 * vtens2)
    new_t[np1] = sph * (state.t[nm1] + dt2 * ttens)
    new_dp[np1] = sph * (state.dp3d[nm1] - dt2 * divdp)

    new_state = dataclasses.replace(state, u=new_u, v=new_v, t=new_t,
                                    dp3d=new_dp)
    new_derived = dataclasses.replace(
        derived, vn0_u=vn0_u, vn0_v=vn0_v, phi=phi, omega_p=d_omega_p,
        eta_dot_dpdn=derived.eta_dot_dpdn.clone())
    return new_state, new_derived
