"""Vertical recurrences as cumulative sums (counterpart of the rsplit>0
scans of ``tinman_sandbox_tpu/ops/scans.py``). Level axis is -3
([..., nlev, np, np]) throughout.
"""
from __future__ import annotations

import torch

__all__ = ["midpoint_pressure", "preq_hydrostatic", "preq_omega_ps"]


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
