"""Physical constants for the HOMME spectral-element dynamical core.

Values mirror the reference's physical_constants
(fortran/physical_constants.F90:12-31, PhysicalConstants.hpp:10-18). Plain
Python floats (f64), so the f64 oracle and the f32 fast path derive from one
source of truth.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    rearth: float = 6.376e6          # m
    g: float = 9.80616               # m s^-2
    omega: float = 7.292e-5          # s^-1
    Rgas: float = 287.04
    Cp: float = 1005.0
    p0: float = 100000.0
    MWDAIR: float = 28.966
    Rwater_vapor: float = 461.50
    Cpwater_vapor: float = 1870.0

    @property
    def kappa(self) -> float:
        return self.Rgas / self.Cp

    @property
    def rrearth(self) -> float:
        return 1.0 / self.rearth

    @property
    def Rd_on_Rv(self) -> float:
        return self.Rgas / self.Rwater_vapor

    @property
    def Cpd_on_Cpv(self) -> float:
        return self.Cp / self.Cpwater_vapor

    @property
    def ginv(self) -> float:
        return 1.0 / self.g

    @property
    def rgas_over_rvap_m1(self) -> float:
        """(Rvap/Rgas - 1), the virtual-temperature moisture factor
        (routine_mod.F90:196-203)."""
        return self.Rwater_vapor / self.Rgas - 1.0


CONSTANTS = PhysicalConstants()
