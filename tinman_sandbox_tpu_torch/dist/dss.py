"""Direct stiffness summation (DSS) on the field layout as a segment sum
(counterpart of ``tinman_sandbox_tpu/dist/dss.py``).

DSS sums the values that the elements sharing a GLL dof hold for it and
hands the sum back to every alias. Here it is an ``index_add_`` over the
global dof map: the field-layout oracle that the structured DSS and its
kernels are held against.

The projection identity is the correctness anchor:
    dss_project(x) == x   for any x continuous across element boundaries.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import NPSQ

__all__ = ["dss_sum", "dss_scaled", "dss_project", "rsp_2f",
           "continuity_error_t"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def rsp_2f(spheremp, gdof, ndof: int):
    """Two-float (hi, lo) rspheremp for the FIELD layout: the f64 reciprocal
    of the sum of f32-ROUNDED spheremp over each dof's aliases, split into
    f32 hi + lo. Returns two numpy f32 arrays shaped like ``spheremp``. The
    single-f32 rspheremp carries a fixed-sign ~1e-8 multiplicative bias per
    DSS pass; hi + lo carries 1/S to ~2^-48."""
    shape = _host(spheremp).shape
    sph32 = _host(spheremp).astype(np.float32).astype(np.float64).reshape(-1)
    gd = _host(gdof).reshape(-1)
    s = np.zeros(ndof, np.float64)
    np.add.at(s, gd, sph32)
    r = 1.0 / s[gd]
    hi = r.astype(np.float32)
    lo = (r - hi.astype(np.float64)).astype(np.float32)
    return hi.reshape(shape), lo.reshape(shape)


def _index(gdof, device) -> torch.Tensor:
    if isinstance(gdof, torch.Tensor):
        return gdof.reshape(-1).to(device=device, dtype=torch.long)
    return torch.from_numpy(np.asarray(gdof).reshape(-1).astype(np.int64)) \
        .to(device)


def dss_sum(x: torch.Tensor, gdof, ndof: int) -> torch.Tensor:
    """sum over the (e, i, j) aliasing each dof of x[e, ..., i, j], handed
    back to every alias. x: [nelem, ..., np, np]; gdof: [nelem, np, np]."""
    e = x.shape[0]
    mid = x.shape[1:-2]
    cols = x.reshape(e, -1, NPSQ).transpose(1, 2).reshape(e * NPSQ, -1)
    idx = _index(gdof, x.device)
    summed = torch.zeros(ndof, cols.shape[1], dtype=x.dtype, device=x.device)
    summed.index_add_(0, idx, cols)
    out = summed[idx].reshape(e, NPSQ, -1).transpose(1, 2)
    return out.reshape(e, *mid, 4, 4).contiguous()


def _lift(r, ndim: int):
    while r.ndim < ndim:
        r = r[:, None]          # broadcast level axes between element and GLL
    return r


def dss_scaled(x: torch.Tensor, gdof, ndof: int, rspheremp) -> torch.Tensor:
    """rspheremp * DSS(x): the assembly of an already spheremp-weighted
    update (routine_mod.F90:182-190 writes spheremp*(...)). ``rspheremp``
    may be a ``(hi, lo)`` two-float pair (``rsp_2f``): the product is then
    y*hi + y*lo."""
    y = dss_sum(x, gdof, ndof)
    if isinstance(rspheremp, tuple):
        hi, lo = (_lift(torch.as_tensor(r, device=x.device), x.ndim)
                  for r in rspheremp)
        return y * hi + y * lo
    return _lift(rspheremp, x.ndim) * y


def dss_project(x: torch.Tensor, gdof, ndof: int, spheremp,
                rspheremp) -> torch.Tensor:
    """Mass-weighted continuous projection:
    (sum_e spheremp*x) / (sum_e spheremp) at every shared dof."""
    return dss_scaled(_lift(spheremp, x.ndim) * x, gdof, ndof, rspheremp)


def continuity_error_t(x: torch.Tensor, gdof) -> float:
    """max |x - x at the first alias of the same dof| over a transposed
    [k, E16] field (lane e*16 + i*4 + j): 0 exactly when every alias of
    every dof holds the same value."""
    g = _host(gdof).reshape(-1)
    first = np.unique(g, return_index=True)[1]
    canon = torch.from_numpy(first[g].astype(np.int64)).to(x.device)
    return float((x - x[:, canon]).abs().max())
