"""Golden regression data transcribed from the reference's test_mod.F90
(counterpart of ``tinman_sandbox_tpu/golden.py``; ``data/golden_caar.npz`` is
a byte-for-byte copy of that package's file).

The arrays are the expected T / u / v of element 1 at time level np1 after the
canonical analytic-init run (fortran/test_mod.F90:8,299,594). The reference's
benchmark loop never rotates time levels, so the golden arrays equal the
single-step output.

Stored shape: [nlev, j, i] (Fortran fill order); `golden_caar()` returns them
transposed to this package's [nlev, i, j].
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "golden_caar.npz")


def golden_caar() -> Dict[str, np.ndarray]:
    """Returns {'T','v1','v2'} arrays of shape [nlev, np_i, np_j] (f64)."""
    with np.load(_DATA) as z:
        return {k: np.ascontiguousarray(z[k].transpose(0, 2, 1)) for k in z.files}
