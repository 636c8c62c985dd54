"""Global energy and mass diagnostics (counterpart of
``tinman_sandbox_tpu/ops/diagnostics.py``).

spheremp-weighted global integrals of kinetic, internal and
surface-potential energy and of air mass,

    KE = (1/g) sum spheremp * 0.5*(u^2+v^2) * dp
    IE = (1/g) sum spheremp * Cp * T * dp
    PE = (1/g) sum spheremp * phis * dp
    M  = (1/g) sum spheremp * dp

computed in f64 whatever the state's dtype (diagnostics must not drift).
The reference carries HOMME's energy accumulators only as dead code
(elem_accum_t, element_mod.F90:127-196).
"""
from __future__ import annotations

import torch

from ..constants import CONSTANTS

__all__ = ["energy_diagnostics", "energy_diagnostics_packed_t",
           "global_integral"]


def global_integral(field: torch.Tensor, spheremp: torch.Tensor):
    """Sum over elements, levels and GLL points of spheremp * field, in f64.
    field [nelem, nlev, np, np]; spheremp [nelem, np, np]."""
    return (spheremp.double()[:, None] * field.double()).sum()


def _budget(u, v, t, dp, phis, integral):
    c = CONSTANTS
    ginv = 1.0 / c.g
    return {
        "KE": ginv * integral(0.5 * (u * u + v * v) * dp),
        "IE": ginv * c.Cp * integral(t * dp),
        "PE": ginv * integral(phis * dp),
        "M": ginv * integral(dp),
    }


def energy_diagnostics(state, spheremp, cfg, tl: int | None = None) -> dict:
    """{'KE', 'IE', 'PE', 'M'} at time level ``tl`` (default n0), each a
    0-d f64 tensor on the state's device."""
    tl = cfg.n0 if tl is None else tl
    return _budget(state.u[tl].double(), state.v[tl].double(),
                   state.t[tl].double(), state.dp3d[tl].double(),
                   state.phis.double()[:, None],
                   lambda f: global_integral(f, spheremp))


def energy_diagnostics_packed_t(s: torch.Tensor, meta: torch.Tensor,
                                nlev: int) -> dict:
    """``energy_diagnostics`` on the packed stacked state [4*nlev, E16]
    (u, v, T, dp row blocks), spheremp and phis read from the meta rows
    [16, E16]: the monitoring hook of long packed runs, no unpacking."""
    from ..kernels.layout import META_COLS     # kernels imports ops

    k = nlev
    u, v, t, dp = (s[i * k:(i + 1) * k].double() for i in range(4))
    sph = meta[META_COLS.index("spheremp")].double()[None]
    phis = meta[META_COLS.index("phis")].double()[None]
    return _budget(u, v, t, dp, phis, lambda f: (sph * f).sum())
