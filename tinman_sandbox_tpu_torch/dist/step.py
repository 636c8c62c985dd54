"""The assembled timestep in array form: CAAR + DSS of the updated fields
(counterpart of ``tinman_sandbox_tpu/dist/step.py::caar_dss_step``).

The CAAR apply writes spheremp-weighted updates (routine_mod.F90:182-190);
the assembly then sums shared dofs and multiplies by rspheremp. Here that
is ``caar_array`` followed by the segment-sum ``dss_scaled`` on the np1
prognostics: the f64 oracle of the assembled step.
"""
from __future__ import annotations

import dataclasses

from ..config import Config
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord
from ..kernels.caar_array import caar_array
from ..state import Derived, State
from .dss import dss_scaled

__all__ = ["caar_dss_step"]


def caar_dss_step(state: State, derived: Derived, geom: Geometry,
                  hv: HybridVCoord, gdof, ndof: int, cfg: Config, dt2,
                  eta_ave_w, moist: bool = True, device="cuda"):
    """One CAAR evaluation + DSS assembly of u, v, T, dp3d at np1. Returns
    (new_state, new_derived) on ``device``."""
    dev = resolve_device(device)
    state, derived = caar_array(state, derived, geom, hv, cfg, dt2,
                                eta_ave_w, moist=moist, device=dev)
    rsp = geom.rspheremp.to(dev)
    np1 = cfg.np1

    def put(x):
        out = x.clone()
        out[np1] = dss_scaled(x[np1], gdof, ndof, rsp)
        return out

    return dataclasses.replace(state, u=put(state.u), v=put(state.v),
                               t=put(state.t), dp3d=put(state.dp3d)), derived
