"""Typed run configuration (counterpart of ``tinman_sandbox_tpu/config.py``).

One frozen dataclass carries the problem dimensions, the time step and the
leapfrog time-level indices, in place of the reference's config.h dims,
CMake cache options and CLI flags.
"""
from __future__ import annotations

import dataclasses

NP = 4                   # GLL points per element edge (config.h.in NP)
NPSQ = NP * NP
NUM_TIME_LEVELS = 3       # leapfrog: nm1 / n0 / np1 (config.h.in NUM_TIME_LEVELS)
QDP_TIME_LEVELS = 2       # tracer-mass time levels


@dataclasses.dataclass(frozen=True)
class Config:
    """Problem + run configuration."""

    # -- dimensions (reference kinds.F90:13-27) --
    nlev: int = 72                    # vertical levels (PLEV)
    qsize: int = 1                    # number of tracers (QSIZE_D)
    nelem: int = 3                    # total elements (nelemd default, kinds.F90:21)

    # -- time integration --
    dt: float = 600.0                 # full timestep seconds (kokkos_init.cpp:97)
    rsplit: int = 1                   # >0: vertically-Lagrangian (no vertical advection)
    nsteps: int = 1

    # -- time-level indices (0-based; reference kinds.F90:23-26 are 1-based) --
    n0: int = 0
    np1: int = 1
    nm1: int = 2
    qn0: int = 0
