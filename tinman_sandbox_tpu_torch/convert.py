"""Carry a problem across from the JAX package as plain numpy arrays.

``from_numpy`` takes each dataclass of ``tinman_sandbox_tpu`` as a mapping
of field name to array (for example
``{f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}``)
and returns this package's dataclasses on the requested device, so both
packages compute on the same numbers. ``cubed_sphere_from_numpy`` and
``plan_from_fields`` do the same for a cubed sphere and its structured DSS
plan, so both packages assemble on the very same geometry, dof map and edge
orientations. This package never touches a JAX object itself.
``pack_qdp_t`` / ``unpack_qdp_t`` carry a state's tracers to and from the
stacked tracer-major [qsize*nlev, E16] layout of the packed steps.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .device import from_arrays
from .grid import Geometry, HybridVCoord
from .state import Derived, State

__all__ = ["from_numpy", "cubed_sphere_from_numpy", "plan_from_fields",
           "pack_qdp_t", "unpack_qdp_t"]


def from_numpy(state: Mapping, derived: Mapping, geom: Mapping, hv: Mapping,
               device="cuda"):
    """(State, Derived, Geometry, HybridVCoord) from mappings of numpy
    arrays, each array keeping its dtype; ``hv['ps0']`` becomes a Python
    float."""
    return tuple(from_arrays(cls, arrays, device=device) for cls, arrays in
                 ((State, state), (Derived, derived), (Geometry, geom),
                  (HybridVCoord, hv)))


def cubed_sphere_from_numpy(mesh: Mapping, geometry: Mapping, dtype=None,
                            device="cuda"):
    """A ``dist.CubedSphere`` from a mapping of the mesh's fields (ne, nelem,
    sphere_xyz, lat, lon, gdof, ndof, multiplicity) and a mapping of its
    geometry's arrays; the geometry lands on ``device`` (in ``dtype``, else
    each array's own), the index arrays stay numpy."""
    from .dist.cubed_sphere import CubedSphere

    arrays = {k: np.asarray(mesh[k]) for k in
              ("sphere_xyz", "lat", "lon", "gdof", "multiplicity")}
    return CubedSphere(ne=int(mesh["ne"]), nelem=int(mesh["nelem"]),
                       ndof=int(mesh["ndof"]),
                       geometry=from_arrays(Geometry, geometry, dtype, device),
                       **arrays)


def plan_from_fields(ne, edges, corner_rows):
    """A ``dist.StructuredDssPlan`` from plain values: ``edges`` as 12
    (face_a, side_a, face_b, side_b, flip) and ``corner_rows`` as 8 lane
    triples."""
    from .dist.structured_dss import StructuredDssPlan

    return StructuredDssPlan(
        ne=int(ne),
        edges=tuple((int(fa), str(sa), int(fb), str(sb), bool(fl))
                    for fa, sa, fb, sb, fl in edges),
        corner_rows=tuple(tuple(int(r) for r in c) for c in corner_rows))


def pack_qdp_t(state: State, cfg, dtype=None):
    """The tracers of time level qn0, [nelem, qsize, nlev, np, np], stacked
    tracer-major into [qsize*nlev, E16] (row = tracer*nlev + level)."""
    from .kernels.layout import pack_field_t

    q = state.qdp[cfg.qn0]
    q = q if dtype is None else q.to(dtype)
    packed = pack_field_t(q.movedim(1, 0))           # [qsize, nlev, E16]
    return packed.reshape(-1, packed.shape[-1])


def unpack_qdp_t(qdp, nelem: int, nlev: int):
    """[qsize*nlev, E16] stacked tracers -> [nelem, qsize, nlev, np, np]."""
    from .kernels.layout import unpack_field_t

    q = unpack_field_t(qdp.reshape(-1, nlev, qdp.shape[-1]), nelem)
    return q.movedim(0, 1).contiguous()
