"""Batched GLL sphere operators (counterpart of the strong-form operators of
``tinman_sandbox_tpu/ops/sphere.py``).

Each operator is a 4x4 Dvv contraction over arbitrary leading batch axes
([nelem, nlev, np, np] in practice). Index conventions follow grid.py:
fields are [..., i, j]; Dvv[i, l]; tensors dinv[..., a, b, i, j] =
reference Dinv(i,j,a+1,b+1). Strong derivatives contract Dvv transposed
(``_dx``, ``_dy``); the weak, integrated-by-parts forms contract it
untransposed (``_ax``, ``_ay``), the discrete adjoint.
"""
from __future__ import annotations

import torch

__all__ = [
    "gradient_sphere",
    "gradient_sphere_update",
    "divergence_sphere",
    "divergence_sphere_update",
    "divergence_sphere_wk",
    "vorticity_sphere",
    "vorticity_sphere_vector",
    "laplace_simple",
    "laplace_tensor",
    "laplace_tensor_replace",
    "curl_sphere_wk_testcov",
    "grad_sphere_wk_testcov",
    "vlaplace_sphere_wk_cartesian",
    "vlaplace_sphere_wk_cartesian_reduced",
    "vlaplace_sphere_wk_contra",
    "full_precision_matmuls",
]


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


def _ax(dvv, x):
    """Weak (adjoint) contraction along axis -2: out[..., m, n] = sum_s Dvv[m,s] x[..., s, n]."""
    full_precision_matmuls()
    return torch.einsum("ms,...sn->...mn", dvv, x)


def _ay(dvv, x):
    """Weak (adjoint) contraction along axis -1: out[..., m, n] = sum_s x[..., m, s] Dvv[n,s]."""
    full_precision_matmuls()
    return torch.einsum("...ms,ns->...mn", x, dvv)


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


def gradient_sphere_update(s, dvv, dinv, rrearth, acc1, acc2):
    """gradient_sphere accumulated into (acc1, acc2)
    (SphereOperators.hpp:271-312)."""
    g1, g2 = gradient_sphere(s, dvv, dinv, rrearth)
    return acc1 + g1, acc2 + g2


def divergence_sphere(v1, v2, dvv, dinv, metdet, rmetdet, rrearth):
    """Spherical divergence of a latlon vector (SphereOperators.hpp:314-358,
    derivative_mod_base.F90:182-230)."""
    gv1 = metdet * (_t(dinv, 0, 0) * v1 + _t(dinv, 0, 1) * v2)
    gv2 = metdet * (_t(dinv, 1, 0) * v1 + _t(dinv, 1, 1) * v2)
    return (_dx(dvv, gv1) + _dy(dvv, gv2)) * (rmetdet * rrearth)


def divergence_sphere_update(v1, v2, alpha, beta, div_in, dvv, dinv, metdet,
                             rmetdet, rrearth):
    """div_out = beta*div_in + alpha*div(v) (SphereOperators.hpp:362-403);
    the tracer Euler step's fused update."""
    return beta * div_in + alpha * divergence_sphere(
        v1, v2, dvv, dinv, metdet, rmetdet, rrearth)


def vorticity_sphere(u, v, dvv, d, rmetdet, rrearth):
    """Spherical vorticity of latlon velocity (u, v) (SphereOperators.hpp:
    405-449, derivative_mod_base.F90:127-177 ``vorticity_v2``): covariant
    transform vco = D.v, then the curl contraction scaled by rmetdet*rrearth."""
    vco1 = _t(d, 0, 0) * u + _t(d, 1, 0) * v
    vco2 = _t(d, 0, 1) * u + _t(d, 1, 1) * v
    return (_dx(dvv, vco2) - _dy(dvv, vco1)) * (rmetdet * rrearth)


def vorticity_sphere_vector(v, dvv, d, rmetdet, rrearth):
    """vorticity_sphere taking the velocity as one stacked [..., 2, np, np]
    vector (SphereOperators.hpp:451-491)."""
    return vorticity_sphere(v[..., 0, :, :], v[..., 1, :, :], dvv, d, rmetdet,
                            rrearth)


# -- weak-form operators ------------------------------------------------------

def divergence_sphere_wk(v1, v2, dvv, dinv, spheremp, rrearth):
    """Weak divergence (SphereOperators.hpp:493-534): the discrete adjoint of
    gradient_sphere under the spheremp inner product,
      <grad(phi), v>_spheremp = -<phi, div_wk(v)>."""
    c1 = _t(dinv, 0, 0) * v1 + _t(dinv, 0, 1) * v2
    c2 = _t(dinv, 1, 0) * v1 + _t(dinv, 1, 1) * v2
    return -rrearth * (_ax(dvv, spheremp * c1) + _ay(dvv, spheremp * c2))


def laplace_simple(s, dvv, dinv, spheremp, rrearth):
    """Scalar Laplacian, weak form: div_wk(grad(s))
    (SphereOperators.hpp:537-550)."""
    g1, g2 = gradient_sphere(s, dvv, dinv, rrearth)
    return divergence_sphere_wk(g1, g2, dvv, dinv, spheremp, rrearth)


def laplace_tensor(s, dvv, dinv, spheremp, tensor_visc, rrearth):
    """Tensor-hyperviscosity Laplacian: div_wk(V^T . grad(s))
    (SphereOperators.hpp:555-596). tensor_visc is [..., 2, 2, np, np]; the
    reference contracts the tensor TRANSPOSED (hpp:576-579), which only
    matters for a non-symmetric V."""
    g1, g2 = gradient_sphere(s, dvv, dinv, rrearth)
    t1 = _t(tensor_visc, 0, 0) * g1 + _t(tensor_visc, 1, 0) * g2
    t2 = _t(tensor_visc, 0, 1) * g1 + _t(tensor_visc, 1, 1) * g2
    return divergence_sphere_wk(t1, t2, dvv, dinv, spheremp, rrearth)


def laplace_tensor_replace(s, dvv, dinv, spheremp, tensor_visc, rrearth):
    """laplace_tensor under the reference's input-replaced-by-output name
    (SphereOperators.hpp:600-638). Nothing aliases here, so the computation
    is laplace_tensor's; kept as an entry point for call-site parity."""
    return laplace_tensor(s, dvv, dinv, spheremp, tensor_visc, rrearth)


def curl_sphere_wk_testcov(s, dvv, d, mp, rrearth):
    """Weak curl of a scalar against covariant test functions
    (SphereOperators.hpp:640-692). Returns latlon (c1, c2)."""
    x = mp * s
    buf0 = -_ay(dvv, x)
    buf1 = _ax(dvv, x)
    c1 = (_t(d, 0, 0) * buf0 + _t(d, 0, 1) * buf1) * rrearth
    c2 = (_t(d, 1, 0) * buf0 + _t(d, 1, 1) * buf1) * rrearth
    return c1, c2


def grad_sphere_wk_testcov(s, dvv, d, mp, metinv, metdet, rrearth):
    """Weak gradient against covariant test functions
    (SphereOperators.hpp:694-771). Returns latlon (g1, g2)."""
    x = mp * s
    ax = _ax(dvv, x)
    ay = _ay(dvv, x)
    buf0 = -metdet * (_t(metinv, 0, 0) * ax + _t(metinv, 1, 0) * ay)
    buf1 = -metdet * (_t(metinv, 0, 1) * ax + _t(metinv, 1, 1) * ay)
    g1 = (_t(d, 0, 0) * buf0 + _t(d, 0, 1) * buf1) * rrearth
    g2 = (_t(d, 1, 0) * buf0 + _t(d, 1, 1) * buf1) * rrearth
    return g1, g2


# -- vector Laplacians (hyperviscosity building blocks) -----------------------

def _cartesian_laplacians(v1, v2, dvv, dinv, spheremp, tensor_visc,
                          vec_sph2cart, rrearth):
    """The latlon vector projected onto the 3 cartesian components, each
    through laplace_tensor, projected back. vec_sph2cart is
    [..., 2, 3, np, np]."""
    laps = [laplace_tensor(
        vec_sph2cart[..., 0, c, :, :] * v1 + vec_sph2cart[..., 1, c, :, :] * v2,
        dvv, dinv, spheremp, tensor_visc, rrearth) for c in range(3)]
    l1 = sum(vec_sph2cart[..., 0, c, :, :] * laps[c] for c in range(3))
    l2 = sum(vec_sph2cart[..., 1, c, :, :] * laps[c] for c in range(3))
    return l1, l2


def vlaplace_sphere_wk_cartesian(v1, v2, dvv, dinv, spheremp, tensor_visc,
                                 vec_sph2cart, rrearth):
    """Vector Laplacian via 3 cartesian-component tensor Laplacians, FULL
    variant (SphereOperators.hpp:777-844): no rigid-rotation term."""
    return _cartesian_laplacians(v1, v2, dvv, dinv, spheremp, tensor_visc,
                                 vec_sph2cart, rrearth)


def vlaplace_sphere_wk_cartesian_reduced(v1, v2, dvv, dinv, spheremp,
                                         tensor_visc, vec_sph2cart, rrearth):
    """'_reduced' cartesian vector Laplacian (SphereOperators.hpp:849-935):
    the same three component Laplacians plus the undamped-rigid-rotation
    term +2*spheremp*rrearth^2*v (hpp:891-903)."""
    l1, l2 = _cartesian_laplacians(v1, v2, dvv, dinv, spheremp, tensor_visc,
                                   vec_sph2cart, rrearth)
    rigid = 2.0 * spheremp * rrearth * rrearth
    return l1 + rigid * v1, l2 + rigid * v2


def vlaplace_sphere_wk_contra(v1, v2, dvv, d, dinv, mp, spheremp, metinv,
                              metdet, rmetdet, rrearth, nu_ratio):
    """Vector Laplacian, contravariant formulation: grad_wk(nu_ratio*div) -
    curl_wk(vort) + undamped rigid rotation (SphereOperators.hpp:938-994)."""
    div = divergence_sphere(v1, v2, dvv, dinv, metdet, rmetdet, rrearth)
    vort = vorticity_sphere(v1, v2, dvv, d, rmetdet, rrearth)
    g1, g2 = grad_sphere_wk_testcov(nu_ratio * div, dvv, d, mp, metinv,
                                    metdet, rrearth)
    c1, c2 = curl_sphere_wk_testcov(vort, dvv, d, mp, rrearth)
    rigid = 2.0 * spheremp * rrearth * rrearth
    return rigid * v1 + (g1 - c1), rigid * v2 + (g2 - c2)
