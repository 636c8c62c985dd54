"""Thermodynamic helpers."""
from __future__ import annotations

__all__ = ["virtual_temperature"]


def virtual_temperature(t, qdp, dp, rvap_over_rgas_m1):
    """T_v = T*(1 + (Rvap/Rgas - 1)*Q), Q = Qdp/dp
    (routine_mod.F90:95-118, 196-203; CaarFunctor.hpp:336-366)."""
    return t * (1.0 + rvap_over_rgas_m1 * (qdp / dp))
