"""CAAR in array form and on the packed layout, the hyperviscosity
Laplacians, the tracer stages and the saxpby triad (the DSS kernels are in
``dss.py``).

The CUDA kernels live in ``../csrc`` and are built at first launch
(``_build.py``); importing these modules builds nothing.
"""
from .caar_array import caar_array
from .caar_t import caar_packed_t, caar_t, caar_t4_cuda, caar_t4_plain, run_leapfrog_t
from .hypervis_t import vlap_cuda, vlap_plain
from .tracer_t import (
    tracer_euler_cuda,
    tracer_euler_plain,
    tracer_limit_cuda,
    tracer_limit_plain,
)
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
    "tracer_euler_cuda",
    "tracer_euler_plain",
    "tracer_limit_cuda",
    "tracer_limit_plain",
    "vlap_cuda",
    "vlap_plain",
]
