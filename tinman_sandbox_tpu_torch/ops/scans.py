"""Vertical recurrences as cumulative sums (counterpart of
``tinman_sandbox_tpu/ops/scans.py``): the three scans of every step and the
interface mass flux and vertical advection of the rsplit=0 path. Level axis
is -3 ([..., nlev, np, np]) throughout.
"""
from __future__ import annotations

import torch

__all__ = ["midpoint_pressure", "preq_hydrostatic", "preq_omega_ps",
           "eta_dot_dpdn_rsplit0", "preq_vertadv"]


def midpoint_pressure(hyai0_ps0, dp):
    """Midpoint pressure (routine_mod.F90:72-75):
    p(k) = hyai(1)*ps0 + cumsum(dp)(k) - dp(k)/2."""
    return hyai0_ps0 + torch.cumsum(dp, dim=-3) - dp * 0.5


def preq_hydrostatic(phis, t_v, p, dp, rgas):
    """Geopotential by reverse vertical integral (routine_mod.F90:255-293):
    phi(k) = phis + revcumsum_{l>k}(q(l)) + q(k)/2, q = Rgas*T_v*dp/p."""
    q = rgas * t_v * (dp / p)
    rev = torch.flip(torch.cumsum(torch.flip(q, (-3,)), dim=-3), (-3,))
    return phis[..., None, :, :] + (rev - q) + 0.5 * q


def preq_omega_ps(p, vgrad_p, divdp):
    """Omega/p diagnostic by forward scan (routine_mod.F90:207-252):
    omega_p(k) = (vgrad_p(k) - cumsum_{l<k}(divdp) - divdp(k)/2) / p(k)."""
    csum = torch.cumsum(divdp, dim=-3) - divdp
    return (vgrad_p - csum - 0.5 * divdp) / p


def eta_dot_dpdn_rsplit0(divdp, hybi):
    """Interface vertical mass flux for the eta-coordinate (rsplit=0) path
    (routine_extracted.F90:224-254):
      eta(k+1) = hybi(k+1) * sum_l(divdp) - cumsum(divdp)(k),
      eta(1) = eta(nlev+1) = 0.
    Returns (eta [..., nlev+1, np, np], sdot_sum [..., 1, np, np])."""
    cum = torch.cumsum(divdp, dim=-3)
    sdot_sum = cum[..., -1:, :, :]
    hybi_in = torch.as_tensor(hybi, dtype=divdp.dtype,
                              device=divdp.device)[1:-1]
    inner = hybi_in[:, None, None] * sdot_sum - cum[..., :-1, :, :]
    zero = torch.zeros_like(sdot_sum)
    return torch.cat([zero, inner, zero], dim=-3), sdot_sum


def preq_vertadv(t, u, v, eta, rpdel):
    """Vertical advection tendencies (CaarFunctor.hpp:504-547,
    routine_extracted.F90:258-260):
      facp(k) = 0.5*rpdel(k)*eta(k+1),  facm(k) = 0.5*rpdel(k)*eta(k)
      X_vadv(k) = facp*(X(k+1)-X(k)) + facm*(X(k)-X(k-1))
    with the facm term absent at the top level and facp at the bottom.
    eta is the [..., nlev+1, np, np] interface flux. Returns (t_vadv, u_vadv,
    v_vadv)."""
    facp = 0.5 * rpdel * eta[..., 1:, :, :]     # eta(k+1), zero at bottom
    facm = 0.5 * rpdel * eta[..., :-1, :, :]    # eta(k),   zero at top

    def vadv(x):
        dxp = torch.diff(x, dim=-3)             # x(k+1) - x(k), nlev-1 levels
        zero = torch.zeros_like(x[..., :1, :, :])
        up = torch.cat([dxp, zero], dim=-3)     # facp pairs
        dn = torch.cat([zero, dxp], dim=-3)     # facm pairs
        return facp * up + facm * dn

    return vadv(t), vadv(u), vadv(v)
