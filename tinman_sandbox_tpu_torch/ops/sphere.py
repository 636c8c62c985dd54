"""Batched GLL sphere operators (counterpart of the strong-form operators of
``tinman_sandbox_tpu/ops/sphere.py``).

Each operator is a 4x4 Dvv contraction over arbitrary leading batch axes
([nelem, nlev, np, np] in practice). Index conventions follow grid.py:
fields are [..., i, j]; Dvv[i, l]; tensors dinv[..., a, b, i, j] =
reference Dinv(i,j,a+1,b+1). Only the three operators CAAR needs are here;
the weak-form and Laplacian family comes with hyperviscosity.
"""
from __future__ import annotations

import torch

__all__ = ["gradient_sphere", "divergence_sphere", "vorticity_sphere",
           "full_precision_matmuls"]


def full_precision_matmuls() -> None:
    """Keep float32 matmuls and convolutions out of TF32. TF32 keeps about
    three decimal digits, the analogue of the TPU's 1-pass bf16 mode that
    ``kernels/fdot.py`` measured at 4e-3 error in the JAX package."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dx(dvv, s):
    """Strong derivative along axis -2: out[..., l, j] = sum_i Dvv[i,l] s[..., i, j]."""
    full_precision_matmuls()
    return torch.einsum("il,...ij->...lj", dvv, s)


def _dy(dvv, s):
    """Strong derivative along axis -1: out[..., j, l] = sum_i Dvv[i,l] s[..., j, i]."""
    full_precision_matmuls()
    return torch.einsum("...ji,il->...jl", s, dvv)


def _t(tensor, a, b):
    """2x2 tensor component with trailing [np, np], broadcastable to fields."""
    return tensor[..., a, b, :, :]


def gradient_sphere(s, dvv, dinv, rrearth):
    """Latlon gradient of a scalar (SphereOperators.hpp:228-269,
    derivative_mod_base.F90:25-65). Returns (ds_x, ds_y)."""
    v1 = _dx(dvv, s) * rrearth
    v2 = _dy(dvv, s) * rrearth
    ds1 = _t(dinv, 0, 0) * v1 + _t(dinv, 1, 0) * v2
    ds2 = _t(dinv, 0, 1) * v1 + _t(dinv, 1, 1) * v2
    return ds1, ds2


def divergence_sphere(v1, v2, dvv, dinv, metdet, rmetdet, rrearth):
    """Spherical divergence of a latlon vector (SphereOperators.hpp:314-358,
    derivative_mod_base.F90:182-230)."""
    gv1 = metdet * (_t(dinv, 0, 0) * v1 + _t(dinv, 0, 1) * v2)
    gv2 = metdet * (_t(dinv, 1, 0) * v1 + _t(dinv, 1, 1) * v2)
    return (_dx(dvv, gv1) + _dy(dvv, gv2)) * (rmetdet * rrearth)


def vorticity_sphere(u, v, dvv, d, rmetdet, rrearth):
    """Spherical vorticity of latlon velocity (u, v) (SphereOperators.hpp:
    405-449, derivative_mod_base.F90:127-177 ``vorticity_v2``): covariant
    transform vco = D.v, then the curl contraction scaled by rmetdet*rrearth."""
    vco1 = _t(d, 0, 0) * u + _t(d, 1, 0) * v
    vco2 = _t(d, 0, 1) * u + _t(d, 1, 1) * v
    return (_dx(dvv, vco2) - _dy(dvv, vco1)) * (rmetdet * rrearth)
