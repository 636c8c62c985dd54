"""Carry a problem across from the JAX package as plain numpy arrays.

``from_numpy`` takes each dataclass of ``tinman_sandbox_tpu`` as a mapping
of field name to array (for example
``{f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}``)
and returns this package's dataclasses on the requested device, so both
packages compute on the same numbers. ``cubed_sphere_from_numpy`` and
``plan_from_fields`` do the same for a cubed sphere and its structured DSS
plan, so both packages assemble on the very same geometry, dof map and edge
orientations. This package never touches a JAX object itself.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .device import from_arrays
from .grid import Geometry, HybridVCoord
from .state import Derived, State

__all__ = ["from_numpy", "cubed_sphere_from_numpy", "plan_from_fields"]


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
