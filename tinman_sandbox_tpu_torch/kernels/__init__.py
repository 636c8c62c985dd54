"""CAAR in array form and on the packed layout, and the saxpby triad.

The CUDA kernels live in ``../csrc`` and are built at first launch
(``_build.py``); importing these modules builds nothing.
"""
from .caar_array import caar_array
from .caar_t import caar_packed_t, caar_t, caar_t4_cuda, caar_t4_plain, run_leapfrog_t
from .saxpby import saxpby_bandwidth_gbs, saxpby_cuda, saxpby_plain

__all__ = [
    "caar_array",
    "caar_packed_t",
    "caar_t",
    "caar_t4_cuda",
    "caar_t4_plain",
    "run_leapfrog_t",
    "saxpby_bandwidth_gbs",
    "saxpby_cuda",
    "saxpby_plain",
]
