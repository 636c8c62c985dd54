"""Element geometry, the GLL derivative matrix, and deterministic initializers
(counterpart of ``tinman_sandbox_tpu/grid.py``).

Array conventions (used package-wide):
  * GLL fields carry trailing axes ``[..., i, j]`` where ``i``/``j`` are the
    Fortran first/second GLL indices (0-based). A scalar element field is
    ``[nelem, nlev, np, np]``.
  * 2x2 tensors are stored ``[nelem, 2, 2, np, np]`` with ``D[e, a, b, i, j]``
    equal to the reference's ``D(i,j,a,b)`` (element_mod.F90:244-268).
  * ``Dvv[i, l]`` matches the reference's ``deriv%Dvv(i,l)``
    (fortran/main.F90:87-96): ``d/dx s (l, j) = sum_i Dvv[i, l] * s[i, j]``.

The Dvv values are the single-precision-truncated constants the reference
uses (fortran/main.F90:83-86); the golden outputs were generated from them.
The initializers build in numpy float64 (so both packages see the same
numbers from the same seed) and hand back tensors on the requested device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import NP, Config
from .device import TensorFields, from_arrays

# fortran/main.F90:87-90 — column-major list, Dvv(i,j) = Dvv_init[(j-1)*np+i]
_DVV_INIT = [
    -3.0, -0.80901699437494745, 0.30901699437494745, -0.5,
    4.0450849718747373, 0.0, -1.1180339887498949, 1.5450849718747370,
    -1.5450849718747370, 1.1180339887498949, 0.0, -4.0450849718747373,
    0.5, -0.30901699437494745, 0.80901699437494745, 3.0,
]

# GLL quadrature weights on [-1, 1] for np=4
GLL_WEIGHTS_NP4 = np.array(
    [1.0 / 6.0, 5.0 / 6.0, 5.0 / 6.0, 1.0 / 6.0], dtype=np.float64
)


def dvv_matrix(dtype=np.float64) -> np.ndarray:
    """The 4x4 GLL pseudo-spectral derivative matrix, indexed Dvv[i, l]."""
    return np.asarray(_DVV_INIT, dtype=dtype).reshape(NP, NP).T.copy()


@dataclasses.dataclass
class Geometry(TensorFields):
    """Per-element metric terms (element_mod.F90:244-268) + the Dvv operator."""

    dvv: torch.Tensor           # [np, np]        Dvv[i, l]
    fcor: torch.Tensor          # [nelem, np, np] Coriolis
    metdet: torch.Tensor        # [nelem, np, np] |g| metric determinant
    rmetdet: torch.Tensor       # [nelem, np, np] 1/metdet
    spheremp: torch.Tensor      # [nelem, np, np] spectral mass matrix
    rspheremp: torch.Tensor     # [nelem, np, np] 1/DSS(spheremp)
    d: torch.Tensor             # [nelem, 2, 2, np, np]  map covariant->latlon
    dinv: torch.Tensor          # [nelem, 2, 2, np, np]  inverse map
    mp: torch.Tensor            # [nelem, np, np] reference-element mass
    metinv: torch.Tensor        # [nelem, 2, 2, np, np] inverse covariant metric
    vec_sph2cart: torch.Tensor  # [nelem, 2, 3, np, np] latlon->cartesian map


@dataclasses.dataclass
class HybridVCoord(TensorFields):
    """Hybrid vertical coordinate (hybvcoord_mod.F90:17-29). Only ps0 and
    hyai[0] feed CAAR; the rest is kept for parity."""

    ps0: float
    hyai: torch.Tensor          # [nlev+1]
    hybi: torch.Tensor          # [nlev+1]
    hyam: torch.Tensor          # [nlev]
    hybm: torch.Tensor          # [nlev]


def _metinv_from_d(d: np.ndarray) -> np.ndarray:
    """Inverse covariant metric (met = D^T D, metinv = met^-1)."""
    m00 = d[:, 0, 0] * d[:, 0, 0] + d[:, 1, 0] * d[:, 1, 0]
    m01 = d[:, 0, 0] * d[:, 0, 1] + d[:, 1, 0] * d[:, 1, 1]
    m11 = d[:, 0, 1] * d[:, 0, 1] + d[:, 1, 1] * d[:, 1, 1]
    det = m00 * m11 - m01 * m01
    metinv = np.empty_like(d)
    metinv[:, 0, 0] = m11 / det
    metinv[:, 1, 1] = m00 / det
    metinv[:, 0, 1] = -m01 / det
    metinv[:, 1, 0] = -m01 / det
    return metinv


def _analytic_vec_sph2cart(nelem: int) -> np.ndarray:
    """Deterministic latlon->cartesian map; the reference never initializes
    vec_sphere2cart, so any smooth nondegenerate choice is valid."""
    i = np.arange(1, NP + 1, dtype=np.float64)
    ii = i[:, None] * np.ones((1, NP))
    jj = np.ones((NP, 1)) * i[None, :]
    v = np.empty((nelem, 2, 3, NP, NP), dtype=np.float64)
    v[:, 0, 0] = np.cos(ii)
    v[:, 0, 1] = np.sin(ii + jj)
    v[:, 0, 2] = 0.25 * jj
    v[:, 1, 0] = -np.sin(jj)
    v[:, 1, 1] = np.cos(ii - jj)
    v[:, 1, 2] = 0.5 * ii
    return v


def analytic_geometry(cfg: Config, dtype=torch.float64,
                      device="cuda") -> Geometry:
    """The reference's deterministic analytic metric init (main.F90:103-124).
    1-based i, j, ie."""
    nelem = cfg.nelem
    i = np.arange(1, NP + 1, dtype=np.float64)
    ii = i[:, None] * np.ones((1, NP))
    jj = np.ones((NP, 1)) * i[None, :]
    bc = lambda x: np.broadcast_to(x, (nelem, NP, NP)).copy()

    metdet = bc(ii * jj)
    spheremp = bc(2.0 * ii)
    d = np.zeros((nelem, 2, 2, NP, NP))
    dinv = np.zeros((nelem, 2, 2, NP, NP))
    d[:, 0, 0] = 1.0
    d[:, 1, 1] = 2.0
    dinv[:, 0, 0] = 1.0
    dinv[:, 1, 1] = 0.5
    return from_arrays(Geometry, dict(
        dvv=dvv_matrix(),
        fcor=bc(np.sin(ii + jj)),
        metdet=metdet,
        rmetdet=1.0 / metdet,
        spheremp=spheremp,
        rspheremp=1.0 / spheremp,
        d=d,
        dinv=dinv,
        mp=bc(GLL_WEIGHTS_NP4[:, None] * GLL_WEIGHTS_NP4[None, :]),
        metinv=_metinv_from_d(d),
        vec_sph2cart=_analytic_vec_sph2cart(nelem),
    ), dtype, device)


def analytic_hvcoord(cfg: Config, dtype=torch.float64,
                     device="cuda") -> HybridVCoord:
    """Reference hvcoord init: ps0=10, hyai(k) = nlev+2-k (main.F90:159-162)."""
    k = np.arange(1, cfg.nlev + 2, dtype=np.float64)
    hyai = cfg.nlev + 2 - k
    hybi = np.zeros(cfg.nlev + 1)
    return from_arrays(HybridVCoord, dict(
        ps0=10.0, hyai=hyai, hybi=hybi,
        hyam=0.5 * (hyai[:-1] + hyai[1:]), hybm=0.5 * (hybi[:-1] + hybi[1:]),
    ), dtype, device)


def random_geometry(cfg: Config, seed: int = 0, dtype=torch.float64,
                    device="cuda") -> Geometry:
    """Random-but-well-conditioned metric init (Elements.cpp:101-151 analog):
    D is random with |det| >= 1/64; Dinv is its exact inverse. Draws the same
    numpy ``default_rng`` stream as the JAX package's ``random_geometry``."""
    rng = np.random.default_rng(seed)
    nelem = cfg.nelem

    def randf(*shape, lo=0.5, hi=2.0):
        return rng.uniform(lo, hi, shape)

    d = rng.uniform(-1.0, 1.0, (nelem, 2, 2, NP, NP))
    det = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    bad = np.abs(det) < (1.0 / 64.0)
    d[:, 0, 0] = np.where(bad, d[:, 0, 0] + 1.0, d[:, 0, 0])
    d[:, 1, 1] = np.where(bad, d[:, 1, 1] + 1.0, d[:, 1, 1])
    det = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    dinv = np.empty_like(d)
    dinv[:, 0, 0] = d[:, 1, 1] / det
    dinv[:, 1, 1] = d[:, 0, 0] / det
    dinv[:, 0, 1] = -d[:, 0, 1] / det
    dinv[:, 1, 0] = -d[:, 1, 0] / det

    metdet = randf(nelem, NP, NP)
    spheremp = randf(nelem, NP, NP)
    mp = np.broadcast_to(
        GLL_WEIGHTS_NP4[:, None] * GLL_WEIGHTS_NP4[None, :], (nelem, NP, NP)
    ).copy()
    return from_arrays(Geometry, dict(
        dvv=dvv_matrix(),
        fcor=randf(nelem, NP, NP, lo=-1.0, hi=1.0),
        metdet=metdet,
        rmetdet=1.0 / metdet,
        spheremp=spheremp,
        rspheremp=1.0 / spheremp,
        d=d,
        dinv=dinv,
        mp=mp,
        metinv=_metinv_from_d(d),
        vec_sph2cart=rng.uniform(-1.0, 1.0, (nelem, 2, 3, NP, NP)),
    ), dtype, device)
