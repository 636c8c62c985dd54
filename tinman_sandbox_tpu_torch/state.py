"""Prognostic / derived state and the canonical deterministic init
(counterpart of ``tinman_sandbox_tpu/state.py``).

Struct-of-arrays dataclasses of tensors: time levels lead ([3, nelem, ...]),
elements next, levels, then GLL i, j. The initializers draw in numpy
float64, so the same seed gives both packages the same numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import NP, NUM_TIME_LEVELS, QDP_TIME_LEVELS, Config
from .device import TensorFields, from_arrays, resolve_device

__all__ = ["State", "Derived", "analytic_state", "analytic_derived",
           "random_state", "random_state_device", "zero_derived",
           "uniform"]


@dataclasses.dataclass
class State(TensorFields):
    """Prognostic state (element_state_mod.F90:10-24)."""

    u: torch.Tensor        # [3, nelem, nlev, np, np]  zonal wind
    v: torch.Tensor        # [3, nelem, nlev, np, np]  meridional wind
    t: torch.Tensor        # [3, nelem, nlev, np, np]  temperature
    dp3d: torch.Tensor     # [3, nelem, nlev, np, np]  pressure-level thickness
    ps_v: torch.Tensor     # [3, nelem, np, np]        surface pressure
    phis: torch.Tensor     # [nelem, np, np]           surface geopotential
    qdp: torch.Tensor      # [2, nelem, qsize, nlev, np, np] tracer mass


@dataclasses.dataclass
class Derived(TensorFields):
    """Diagnostic/accumulator state used by CAAR (element_mod.F90:63-124)."""

    vn0_u: torch.Tensor          # [nelem, nlev, np, np]   mass-flux accumulator (u)
    vn0_v: torch.Tensor          # [nelem, nlev, np, np]   mass-flux accumulator (v)
    phi: torch.Tensor            # [nelem, nlev, np, np]   geopotential
    omega_p: torch.Tensor        # [nelem, nlev, np, np]   omega/p accumulator
    eta_dot_dpdn: torch.Tensor   # [nelem, nlev+1, np, np] vertical mass flux accumulator
    pecnd: torch.Tensor          # [nelem, nlev, np, np]   condensate pressure perturbation


def analytic_state(cfg: Config, dtype=torch.float64, device="cuda") -> State:
    """The reference's deterministic analytic init (fortran/main.F90:103-154).
    1-based i, j, k, ie; time levels get +tl*(1|2|3|1) offsets. Qdp is only
    initialized at time level qn0."""
    nelem, nlev, qsize = cfg.nelem, cfg.nlev, cfg.qsize
    ie = np.arange(1, nelem + 1, dtype=np.float64)[:, None, None, None]
    k = np.arange(1, nlev + 1, dtype=np.float64)[None, :, None, None]
    i = np.arange(1, NP + 1, dtype=np.float64)[None, None, :, None]
    j = np.arange(1, NP + 1, dtype=np.float64)[None, None, None, :]
    tl = np.arange(1, NUM_TIME_LEVELS + 1,
                   dtype=np.float64).reshape(-1, 1, 1, 1, 1)

    base_dp = 10.0 * k + ie + i + j
    base_uv = 1.0 + k / 2.0 + i + j + ie / 5.0
    base_t = 1000.0 - k - i - j + ie / 10.0

    qdp = np.zeros((QDP_TIME_LEVELS, nelem, qsize, nlev, NP, NP))
    qdp[cfg.qn0, :, 0] = 1.0 + np.sin(i * j * k)
    return from_arrays(State, dict(
        u=base_uv[None] + tl * 2.0,
        v=base_uv[None] + tl * 3.0,
        t=base_t[None] + tl,
        dp3d=base_dp[None] + tl,
        ps_v=np.zeros((NUM_TIME_LEVELS, nelem, NP, NP)),
        phis=np.broadcast_to(i[0, 0] + j[0, 0], (nelem, NP, NP)).copy(),
        qdp=qdp,
    ), dtype, device)


def analytic_derived(cfg: Config, dtype=torch.float64,
                     device="cuda") -> Derived:
    """Derived-field analytic init (fortran/main.F90:130-134)."""
    nelem, nlev = cfg.nelem, cfg.nlev
    k = np.arange(1, nlev + 1, dtype=np.float64)[None, :, None, None]
    i = np.arange(1, NP + 1, dtype=np.float64)[None, None, :, None]
    j = np.arange(1, NP + 1, dtype=np.float64)[None, None, None, :]
    shape3 = (nelem, nlev, NP, NP)
    return from_arrays(Derived, dict(
        vn0_u=np.ones(shape3),
        vn0_v=np.ones(shape3),
        phi=np.broadcast_to(np.cos(i + 3.0 * j) + k, shape3).copy(),
        omega_p=np.broadcast_to(j * j, shape3).copy(),
        eta_dot_dpdn=np.zeros((nelem, nlev + 1, NP, NP)),
        pecnd=np.ones(shape3),
    ), dtype, device)


def random_state(cfg: Config, seed: int = 1, dtype=torch.float64,
                 device="cuda") -> State:
    """Seeded random init for performance runs (Elements.cpp:101-151 analog):
    dp3d strictly positive so the dp3d>0 invariant holds at step 0. Same
    numpy stream as the JAX package's ``random_state``."""
    rng = np.random.default_rng(seed)
    nelem, nlev, qsize = cfg.nelem, cfg.nlev, cfg.qsize
    s3 = (NUM_TIME_LEVELS, nelem, nlev, NP, NP)
    return from_arrays(State, dict(
        u=rng.uniform(-1, 1, s3),
        v=rng.uniform(-1, 1, s3),
        t=rng.uniform(250, 300, s3),
        dp3d=rng.uniform(10, 20, s3),
        ps_v=rng.uniform(9e4, 1.1e5, (NUM_TIME_LEVELS, nelem, NP, NP)),
        phis=rng.uniform(0, 1, (nelem, NP, NP)),
        qdp=rng.uniform(0, 1, (QDP_TIME_LEVELS, nelem, qsize, nlev, NP, NP)),
    ), dtype, device)


def uniform(gen: torch.Generator, shape, lo: float, hi: float,
            dtype=torch.float32) -> torch.Tensor:
    """U(lo, hi) of ``shape`` drawn from ``gen`` on its device."""
    return torch.empty(shape, dtype=dtype, device=gen.device).uniform_(
        lo, hi, generator=gen)


def random_state_device(cfg: Config, seed: int = 1, dtype=torch.float32,
                        device="cuda") -> State:
    """``random_state`` drawn on the device from a ``torch.Generator``
    seeded with ``seed``: nothing is staged through the host, which at
    ne120-class grids would be ~10 GB of state. The same distributions as
    ``random_state``, another stream (as in the JAX package)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    nelem, nlev, qsize = cfg.nelem, cfg.nlev, cfg.qsize
    s3 = (NUM_TIME_LEVELS, nelem, nlev, NP, NP)
    u = lambda shape, lo, hi: uniform(gen, shape, lo, hi, dtype)
    return State(
        u=u(s3, -1, 1),
        v=u(s3, -1, 1),
        t=u(s3, 250, 300),
        dp3d=u(s3, 10, 20),
        ps_v=u((NUM_TIME_LEVELS, nelem, NP, NP), 9e4, 1.1e5),
        phis=u((nelem, NP, NP), 0, 1),
        qdp=u((QDP_TIME_LEVELS, nelem, qsize, nlev, NP, NP), 0, 1),
    )


def zero_derived(cfg: Config, dtype=torch.float64, device="cuda") -> Derived:
    nelem, nlev = cfg.nelem, cfg.nlev
    shape3 = (nelem, nlev, NP, NP)
    z = np.zeros
    return from_arrays(Derived, dict(
        vn0_u=z(shape3), vn0_v=z(shape3), phi=z(shape3), omega_p=z(shape3),
        eta_dot_dpdn=z((nelem, nlev + 1, NP, NP)), pecnd=z(shape3),
    ), dtype, device)
