"""The equiangular cubed sphere with np = 4 GLL points an element edge.

The benchmark builds it once a run (NumPy, float64) and hands the same
arrays to the program's set-up and to the reference. Element e of face f
at (ej, ei) is e = f*ne*ne + ej*ne + ei; point (i, j) lies at alpha node i
and beta node j. A global dof is a distinct node position on the unit
sphere. The derivative matrix comes from the GLL nodes by the barycentric
formula, not from a table.

Conventions (HOMME's): the covariant basis a_b = dr/dxi_b on the unit
sphere, D[a, b] = a_b . e_a with e_0 = e_lon and e_1 = e_lat, metdet =
det D, mp the product of the GLL weights, spheremp = mp * metdet,
rspheremp = 1 / (spheremp summed over a dof's aliases). ``dvv[i, l]`` is
dL_i/dx at node l, the operators' contraction sum_i dvv[i, l] s[i].
"""
from __future__ import annotations

import numpy as np

NP = 4
OMEGA = 7.292e-5                         # s^-1, Earth's rotation rate

GLL_NODES = np.array([-1.0, -1.0 / np.sqrt(5.0), 1.0 / np.sqrt(5.0), 1.0])
GLL_WEIGHTS = np.array([1.0 / 6.0, 5.0 / 6.0, 5.0 / 6.0, 1.0 / 6.0])

# a face's axes: point = normalize(z + tan(alpha) x + tan(beta) y)
_FACES = (
    ((0.0, 1, 0), (0.0, 0, 1), (1.0, 0, 0)),
    ((-1.0, 0, 0), (0.0, 0, 1), (0.0, 1, 0)),
    ((0.0, -1, 0), (0.0, 0, 1), (-1.0, 0, 0)),
    ((1.0, 0, 0), (0.0, 0, 1), (0.0, -1, 0)),
    ((0.0, 1, 0), (-1.0, 0, 0), (0.0, 0, 1)),
    ((0.0, 1, 0), (1.0, 0, 0), (0.0, 0, -1)),
)


def derivative_matrix() -> np.ndarray:
    """dvv[i, l] = L_i'(x_l) on the GLL nodes (barycentric weights)."""
    x = GLL_NODES
    n = len(x)
    bw = np.array([1.0 / np.prod([x[i] - x[k] for k in range(n) if k != i])
                   for i in range(n)])
    d = np.zeros((n, n))                 # d[l, i] = L_i'(x_l)
    for l in range(n):
        for i in range(n):
            if i != l:
                d[l, i] = bw[i] / bw[l] / (x[l] - x[i])
        d[l, l] = -d[l].sum()
    return d.T.copy()


def _face(face: int, ne: int):
    """Node positions and covariant basis of a face's elements, [ej, ei,
    i, j, 3] flattened to [ne*ne, 4, 4, 3]."""
    xa, ya, za = (np.array(v, dtype=np.float64) for v in _FACES[face])
    width = (np.pi / 2.0) / ne
    half = width / 2.0
    nodes = -np.pi / 4.0 + (np.arange(ne)[:, None] + 0.5) * width \
        + GLL_NODES[None, :] * half                      # [element, node]
    alpha = nodes[None, :, :, None, None]                # [1, ei, i, 1, 1]
    beta = nodes[:, None, None, :, None]                 # [ej, 1, 1, j, 1]
    s = za + np.tan(alpha) * xa + np.tan(beta) * ya      # [ej, ei, i, j, 3]
    norm = np.linalg.norm(s, axis=-1, keepdims=True)
    r = s / norm

    def along(ds):
        ds = np.broadcast_to(ds, r.shape)
        return (ds - np.sum(ds * r, axis=-1, keepdims=True) * r) / norm

    def flat(x):
        return x.reshape(ne * ne, NP, NP, 3)

    return (flat(r), flat(along(xa / np.cos(alpha) ** 2) * half),
            flat(along(ya / np.cos(beta) ** 2) * half))


def build(ne: int) -> dict:
    """The ne x ne x 6 sphere as float64 NumPy arrays: dvv [4, 4]; d, dinv,
    metinv [nelem, 2, 2, 4, 4]; metdet, rmetdet, mp, spheremp, rspheremp,
    fcor, lat, lon [nelem, 4, 4]; vec_sph2cart [nelem, 2, 3, 4, 4]; gdof
    [nelem, 4, 4] (int64) and ndof."""
    nelem = 6 * ne * ne
    xyz, a1, a2 = (np.concatenate(x) for x in
                   zip(*(_face(face, ne) for face in range(6))))
    lon = np.arctan2(xyz[..., 1], xyz[..., 0])
    lat = np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0))
    e_lon = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)], -1)
    e_lat = np.stack([-np.sin(lat) * np.cos(lon),
                      -np.sin(lat) * np.sin(lon), np.cos(lat)], -1)
    d = np.empty((nelem, 2, 2, NP, NP))
    for a, ea in enumerate((e_lon, e_lat)):
        for b, ab in enumerate((a1, a2)):
            d[:, a, b] = np.sum(ab * ea, -1)
    metdet = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    dinv = np.empty_like(d)
    dinv[:, 0, 0] = d[:, 1, 1] / metdet
    dinv[:, 0, 1] = -d[:, 0, 1] / metdet
    dinv[:, 1, 0] = -d[:, 1, 0] / metdet
    dinv[:, 1, 1] = d[:, 0, 0] / metdet
    # metinv = (D^T D)^-1 = Dinv Dinv^T
    metinv = np.einsum("eacij,ebcij->eabij", dinv, dinv)
    mp = np.broadcast_to(np.outer(GLL_WEIGHTS, GLL_WEIGHTS),
                         (nelem, NP, NP)).copy()
    spheremp = mp * metdet

    _, gdof, counts = np.unique(np.round(xyz.reshape(-1, 3), 9), axis=0,
                                return_inverse=True, return_counts=True)
    gdof = gdof.reshape(nelem, NP, NP).astype(np.int64)
    ndof = int(counts.size)
    if ndof != 6 * ne * ne * (NP - 1) ** 2 + 2 or counts.max() > 4:
        raise AssertionError(f"cubed sphere ne={ne}: {ndof} dofs")
    total = np.zeros(ndof)
    np.add.at(total, gdof.reshape(-1), spheremp.reshape(-1))
    v2c = np.stack([np.moveaxis(e_lon, -1, 1), np.moveaxis(e_lat, -1, 1)], 1)
    return dict(
        ne=ne, nelem=nelem, ndof=ndof, gdof=gdof, lat=lat, lon=lon,
        dvv=derivative_matrix(), d=d, dinv=dinv, metinv=metinv,
        metdet=metdet, rmetdet=1.0 / metdet, mp=mp, spheremp=spheremp,
        rspheremp=1.0 / total[gdof], fcor=2.0 * OMEGA * np.sin(lat),
        vec_sph2cart=v2c)


def eta_levels(nlev: int) -> dict:
    """Monotone hybrid levels on nlev + 1 even eta interfaces: ps0 = 1000,
    hyai = 0.12 (1 - eta), hybi = eta; float64."""
    eta = np.linspace(0.0, 1.0, nlev + 1)
    hyai = 0.12 * (1.0 - eta)
    return dict(ps0=1000.0, hyai=hyai, hybi=eta,
                hyam=0.5 * (hyai[:-1] + hyai[1:]),
                hybm=0.5 * (eta[:-1] + eta[1:]))
