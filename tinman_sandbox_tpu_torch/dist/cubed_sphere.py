"""Equiangular cubed-sphere grid: topology, GLL geometry, global dof map
(counterpart of ``tinman_sandbox_tpu/dist/cubed_sphere.py``).

A real ne x ne x 6 cubed-sphere mesh with per-element metric terms computed
from the sphere mapping, and the shared-dof map that drives DSS. The build
is numpy f64 work, the same arithmetic as the JAX package's, so both give
the same numbers bit for bit; only the finished ``Geometry`` is handed over
as tensors on the requested device.

Conventions match ``grid.Geometry`` and ``ops/sphere.py``:
  * covariant basis a_b = dr/dxi_b on the UNIT sphere (operators multiply by
    rrearth to become dimensional);
  * D[:, a, b] = a_b . e_hat_a with e_hat_0 = e_lon, e_hat_1 = e_lat;
  * metdet = det(D); mp = GLL weight product; spheremp = mp * metdet;
  * rspheremp = 1 / DSS(spheremp) (assembled inverse mass).

Shared GLL dofs between neighbouring elements (the multiplicity-3 cube
corners included) are identified by their 3D coordinates.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import NP
from ..constants import CONSTANTS
from ..device import from_arrays
from ..grid import GLL_WEIGHTS_NP4, Geometry, _metinv_from_d, dvv_matrix

__all__ = ["CubedSphere", "build_cubed_sphere", "GLL_NODES_NP4"]

# GLL nodes on [-1, 1] for np=4
GLL_NODES_NP4 = np.array(
    [-1.0, -1.0 / np.sqrt(5.0), 1.0 / np.sqrt(5.0), 1.0], dtype=np.float64
)

# face triads: point = normalize(z_ax + tan(alpha)*x_ax + tan(beta)*y_ax)
_FACES = [
    (np.array([0.0, 1, 0]), np.array([0.0, 0, 1]), np.array([1.0, 0, 0])),   # +x
    (np.array([-1.0, 0, 0]), np.array([0.0, 0, 1]), np.array([0.0, 1, 0])),  # +y
    (np.array([0.0, -1, 0]), np.array([0.0, 0, 1]), np.array([-1.0, 0, 0])), # -x
    (np.array([1.0, 0, 0]), np.array([0.0, 0, 1]), np.array([0.0, -1, 0])),  # -y
    (np.array([0.0, 1, 0]), np.array([-1.0, 0, 0]), np.array([0.0, 0, 1])),  # +z
    (np.array([0.0, 1, 0]), np.array([1.0, 0, 0]), np.array([0.0, 0, -1])),  # -z
]


@dataclasses.dataclass
class CubedSphere:
    """A cubed-sphere mesh with assembled GLL dof numbering. ``geometry`` is
    tensors on a device; the index arrays stay numpy."""

    ne: int
    nelem: int
    geometry: Geometry            # [nelem, ...] metric terms
    sphere_xyz: Any               # [nelem, np, np, 3] unit-sphere node coords
    lat: Any                      # [nelem, np, np]
    lon: Any                      # [nelem, np, np]
    gdof: Any                     # [nelem, np, np] int32 global dof index
    ndof: int                     # number of unique global dofs
    multiplicity: Any             # [ndof] how many (e,i,j) alias each dof


def _face_points(face: int, ne: int, ei: int, ej: int):
    """Unit-sphere coords + covariant basis for element (ei, ej) on a face:
    (xyz [np,np,3], a1 [np,np,3], a2 [np,np,3]) with a_b = dr/dxi_b."""
    x_ax, y_ax, z_ax = _FACES[face]
    dab = (np.pi / 2.0) / ne              # element width in (alpha, beta)
    half = dab / 2.0
    a0 = -np.pi / 4.0 + ei * dab + half   # element center alpha
    b0 = -np.pi / 4.0 + ej * dab + half
    alpha = a0 + GLL_NODES_NP4 * half     # [np]
    beta = b0 + GLL_NODES_NP4 * half

    ta = np.tan(alpha)[:, None]           # [np_i, 1]
    tb = np.tan(beta)[None, :]            # [1, np_j]
    sec2a = (1.0 / np.cos(alpha) ** 2)[:, None]
    sec2b = (1.0 / np.cos(beta) ** 2)[None, :]

    s = (z_ax[None, None, :]
         + ta[..., None] * x_ax[None, None, :]
         + tb[..., None] * y_ax[None, None, :])          # [np, np, 3]
    norm = np.linalg.norm(s, axis=-1, keepdims=True)
    r = s / norm

    # dr/dalpha = (I - r r^T)/|s| . ds/dalpha, ds/dalpha = sec^2(alpha) x_ax
    def tangential(ds):
        proj = ds - np.sum(ds * r, axis=-1, keepdims=True) * r
        return proj / norm

    dr_da = tangential(sec2a[..., None] * x_ax[None, None, :])
    dr_db = tangential(sec2b[..., None] * y_ax[None, None, :])
    # chain rule to the reference element coordinate xi in [-1, 1]
    return r, dr_da * half, dr_db * half


def build_cubed_sphere(ne: int, dtype=torch.float64,
                       device="cuda") -> CubedSphere:
    """Build the ne x ne x 6 equiangular cubed-sphere GLL mesh; the geometry
    lands as ``dtype`` tensors on ``device``."""
    nelem = 6 * ne * ne
    xyz = np.empty((nelem, NP, NP, 3))
    a1 = np.empty((nelem, NP, NP, 3))
    a2 = np.empty((nelem, NP, NP, 3))
    e = 0
    for face in range(6):
        for ej in range(ne):
            for ei in range(ne):
                xyz[e], a1[e], a2[e] = _face_points(face, ne, ei, ej)
                e += 1

    lon = np.arctan2(xyz[..., 1], xyz[..., 0])
    lat = np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0))

    e_lon = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)], axis=-1)
    e_lat = np.stack(
        [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)],
        axis=-1,
    )

    d = np.empty((nelem, 2, 2, NP, NP))
    d[:, 0, 0] = np.sum(a1 * e_lon, axis=-1)
    d[:, 0, 1] = np.sum(a2 * e_lon, axis=-1)
    d[:, 1, 0] = np.sum(a1 * e_lat, axis=-1)
    d[:, 1, 1] = np.sum(a2 * e_lat, axis=-1)

    metdet = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    dinv = np.empty_like(d)
    dinv[:, 0, 0] = d[:, 1, 1] / metdet
    dinv[:, 0, 1] = -d[:, 0, 1] / metdet
    dinv[:, 1, 0] = -d[:, 1, 0] / metdet
    dinv[:, 1, 1] = d[:, 0, 0] / metdet

    mp = (GLL_WEIGHTS_NP4[:, None] * GLL_WEIGHTS_NP4[None, :])[None]
    mp = np.broadcast_to(mp, (nelem, NP, NP)).copy()
    spheremp = mp * metdet
    fcor = 2.0 * CONSTANTS.omega * np.sin(lat)

    # global dof identification by node coordinates
    flat = np.round(xyz.reshape(-1, 3), 9)
    _, inverse, counts = np.unique(
        flat, axis=0, return_inverse=True, return_counts=True
    )
    gdof = inverse.reshape(nelem, NP, NP).astype(np.int32)
    ndof = int(counts.size)

    # Guard the coordinate-rounding dedup: the closed cubed-sphere quad mesh
    # (F = 6ne^2, E = 12ne^2, V = 6ne^2+2) has F(np-2)^2 + E(np-2) + V =
    # 6ne^2(np-1)^2 + 2 unique GLL dofs, exactly 8 of multiplicity 3 (cube
    # corners) and none above 4.
    expect_ndof = 6 * ne * ne * (NP - 1) ** 2 + 2
    if ndof != expect_ndof or int(counts.max()) > 4 \
            or int(np.sum(counts == 3)) != 8 \
            or int(counts.sum()) != nelem * NP * NP:
        raise AssertionError(
            f"cubed-sphere dof identification failed at ne={ne}: "
            f"ndof={ndof} (expected {expect_ndof}), "
            f"multiplicity histogram={np.bincount(counts)}"
        )

    assembled = np.zeros(ndof)
    np.add.at(assembled, gdof.reshape(-1), spheremp.reshape(-1))
    rspheremp = 1.0 / assembled[gdof]

    v2c = np.empty((nelem, 2, 3, NP, NP))
    v2c[:, 0] = np.moveaxis(e_lon, -1, 1)
    v2c[:, 1] = np.moveaxis(e_lat, -1, 1)

    # The operators contract sum_i dvv[i, l] * s[i] (the reference's index
    # convention); on the increasing GLL nodes used here the differentiation
    # matrix D_std[l, i] = L_i'(x_l) is dvv_matrix(), so the operators take
    # its transpose.
    geometry = from_arrays(Geometry, dict(
        dvv=dvv_matrix().T.copy(),
        fcor=fcor,
        metdet=metdet,
        rmetdet=1.0 / metdet,
        spheremp=spheremp,
        rspheremp=rspheremp,
        d=d,
        dinv=dinv,
        mp=mp,
        metinv=_metinv_from_d(d),
        vec_sph2cart=v2c,
    ), dtype, device)
    return CubedSphere(ne=ne, nelem=nelem, geometry=geometry, sphere_xyz=xyz,
                       lat=lat, lon=lon, gdof=gdof, ndof=ndof,
                       multiplicity=counts)
