"""Carry a problem across from the JAX package as plain numpy arrays.

``from_numpy`` takes each dataclass of ``tinman_sandbox_tpu`` as a mapping
of field name to array (for example
``{f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}``)
and returns this package's dataclasses on the requested device, so both
packages compute on the same numbers. This package never touches a JAX
object itself.
"""
from __future__ import annotations

from typing import Mapping

from .device import from_arrays
from .grid import Geometry, HybridVCoord
from .state import Derived, State

__all__ = ["from_numpy"]


def from_numpy(state: Mapping, derived: Mapping, geom: Mapping, hv: Mapping,
               device="cuda"):
    """(State, Derived, Geometry, HybridVCoord) from mappings of numpy
    arrays, each array keeping its dtype; ``hv['ps0']`` becomes a Python
    float."""
    return tuple(from_arrays(cls, arrays, device=device) for cls, arrays in
                 ((State, state), (Derived, derived), (Geometry, geom),
                  (HybridVCoord, hv)))
