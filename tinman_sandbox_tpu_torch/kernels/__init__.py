"""CAAR in array form and on the two packed layouts, the hyperviscosity
Laplacians, the tracer stages on both layouts, the ring-fused producers,
the saxpby triad, the probe's chained FP32 product and the column remap;
of the DSS kernels (``dss.py``) the multi-device ones.

The CUDA kernels live in ``../csrc`` and are built at first launch
(``_build.py``); importing these modules builds nothing.
"""
from .caar import caar, caar_packed, caar_packed_rsplit0, run_leapfrog
from .caar_array import caar_array
from .caar_t import (
    caar_packed_rsplit0_t,
    caar_packed_t,
    caar_t,
    caar_t4_cuda,
    caar_t4_plain,
    run_leapfrog_t,
)
from .dss import (
    dss_patch_tiles_cuda,
    dss_patch_tiles_plain,
    dss_sweep_banded_cuda,
    dss_sweep_banded_nomerge_cuda,
    dss_sweep_banded_nomerge_plain,
    dss_sweep_banded_plain,
)
from .hypervis_t import vlap_cuda, vlap_plain
from .probe import probe_mm_cuda, probe_mm_plain
from .remap import remap_levels_cuda, remap_packed_cuda, remap_packed_plain
from .ring_fused import (
    caar_ring_packed_t4,
    caar_ring_plain,
    ring_geometry,
    tracer_ring_packed_t,
    tracer_ring_plain,
)
from .tracer_t import (
    tracer_euler_cuda,
    tracer_euler_plain,
    tracer_limit_cuda,
    tracer_limit_plain,
)
from .saxpby import saxpby_bandwidth_gbs, saxpby_cuda, saxpby_plain
from .tracer import euler_packed, euler_step_fast

__all__ = [
    "caar",
    "caar_array",
    "caar_packed",
    "caar_packed_rsplit0",
    "caar_packed_rsplit0_t",
    "caar_packed_t",
    "caar_ring_packed_t4",
    "caar_ring_plain",
    "caar_t",
    "caar_t4_cuda",
    "caar_t4_plain",
    "dss_patch_tiles_cuda",
    "dss_patch_tiles_plain",
    "dss_sweep_banded_cuda",
    "dss_sweep_banded_nomerge_cuda",
    "dss_sweep_banded_nomerge_plain",
    "dss_sweep_banded_plain",
    "euler_packed",
    "euler_step_fast",
    "probe_mm_cuda",
    "probe_mm_plain",
    "remap_levels_cuda",
    "remap_packed_cuda",
    "remap_packed_plain",
    "ring_geometry",
    "run_leapfrog",
    "run_leapfrog_t",
    "saxpby_bandwidth_gbs",
    "saxpby_cuda",
    "saxpby_plain",
    "tracer_euler_cuda",
    "tracer_euler_plain",
    "tracer_limit_cuda",
    "tracer_limit_plain",
    "tracer_ring_packed_t",
    "tracer_ring_plain",
    "vlap_cuda",
    "vlap_plain",
]
