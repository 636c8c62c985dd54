"""tinman_sandbox_tpu_torch — the PyTorch / CUDA port of ``tinman_sandbox_tpu``.

The HOMME compute_and_apply_rhs (CAAR) sandbox on an NVIDIA H100: the f64
oracle, the batched operators and the array-form CAAR step in PyTorch, and
the packed-layout CAAR step and the saxpby triad as hand-written CUDA
kernels (``csrc/``). Module names mirror the JAX package's. Entry points run
on the card unless the caller passes ``device="cpu"``, where each kernel
wrapper runs its plain PyTorch version.
"""

from .config import NP, NPSQ, NUM_TIME_LEVELS, Config
from .constants import CONSTANTS, PhysicalConstants
from .grid import (
    Geometry,
    HybridVCoord,
    analytic_geometry,
    analytic_hvcoord,
    dvv_matrix,
    random_geometry,
)
from .state import Derived, State, analytic_derived, analytic_state, random_state, zero_derived

__version__ = "0.1.0"

__all__ = [
    "NP",
    "NPSQ",
    "NUM_TIME_LEVELS",
    "Config",
    "CONSTANTS",
    "PhysicalConstants",
    "Geometry",
    "HybridVCoord",
    "analytic_geometry",
    "analytic_hvcoord",
    "dvv_matrix",
    "random_geometry",
    "Derived",
    "State",
    "analytic_derived",
    "analytic_state",
    "random_state",
    "zero_derived",
]
