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

__all__ = ["dss_sum", "dss_scaled", "dss_project", "rsp_2f", "mul_2f",
           "continuity_error_t", "dss_scaled_sharded"]


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


def mul_2f(y: torch.Tensor, hi, lo) -> torch.Tensor:
    """y * (hi + lo) for the two-float rspheremp (hi, lo broadcast on y).
    In float32 it is ``fmaf(y, hi, y*lo)``, the DSS kernels' scale: y*lo
    rounded, then y*hi + that rounded once. Two rounded products and a
    rounded sum would lose the lo row wherever y*lo is under half an ulp of
    y*hi (nearly everywhere: lo is ~1e-8 of hi), and with it the fix of
    fl(rspheremp)'s per-dof bias. Emulated exactly: y*hi is exact in
    float64, the float64 sum is rounded to odd (TwoSum's error decides the
    last bit), and rounding that to float32 is the correctly rounded
    result. Other dtypes: y*hi + y*lo."""
    if y.dtype != torch.float32:
        return y * hi + y * lo
    p = y.double() * hi.double()
    q = (y * lo).double()
    s = p + q
    b = s - p
    err = (p - (s - b)) + (q - b)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).float()


def _index(gdof, device) -> torch.Tensor:
    if isinstance(gdof, torch.Tensor):
        return gdof.reshape(-1).to(device=device, dtype=torch.long)
    return torch.from_numpy(np.asarray(gdof).reshape(-1).astype(np.int64)) \
        .to(device)


def to_cols(x: torch.Tensor) -> torch.Tensor:
    """[e, ..., np, np] -> dof-major columns [e*16, prod(mid)]."""
    e = x.shape[0]
    return x.reshape(e, -1, NPSQ).transpose(1, 2).reshape(e * NPSQ, -1)


def from_cols(cols: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of ``to_cols``: [e*16, prod(mid)] -> ``shape``."""
    e = shape[0]
    return cols.reshape(e, NPSQ, -1).transpose(1, 2).reshape(shape) \
        .contiguous()


def dss_sum(x: torch.Tensor, gdof, ndof: int) -> torch.Tensor:
    """sum over the (e, i, j) aliasing each dof of x[e, ..., i, j], handed
    back to every alias. x: [nelem, ..., np, np]; gdof: [nelem, np, np]."""
    cols = to_cols(x)
    idx = _index(gdof, x.device)
    summed = torch.zeros(ndof, cols.shape[1], dtype=x.dtype, device=x.device)
    summed.index_add_(0, idx, cols)
    return from_cols(summed[idx], x.shape)


def _lift(r, ndim: int):
    while r.ndim < ndim:
        r = r[:, None]          # broadcast level axes between element and GLL
    return r


def dss_scaled(x: torch.Tensor, gdof, ndof: int, rspheremp) -> torch.Tensor:
    """rspheremp * DSS(x): the assembly of an already spheremp-weighted
    update (routine_mod.F90:182-190 writes spheremp*(...)). ``rspheremp``
    may be a ``(hi, lo)`` two-float pair (``rsp_2f``): the product is then
    ``mul_2f(y, hi, lo)``."""
    y = dss_sum(x, gdof, ndof)
    if isinstance(rspheremp, tuple):
        hi, lo = (_lift(torch.as_tensor(r, device=x.device), x.ndim)
                  for r in rspheremp)
        return mul_2f(y, hi, lo)
    return _lift(rspheremp, x.ndim) * y


def dss_scaled_sharded(xs, gdof, ndof: int, mesh, rsps) -> list:
    """``dss_scaled`` of an element-sharded field (``xs``: this process's
    contiguous shards) as SPMD partitions the segment sum: each shard adds
    its elements' values into the whole [ndof, nmid] sum, one ``mesh.psum``,
    each shard gathers its own aliases and scales by its ``rsps``."""
    gd = _host(gdof).reshape(mesh.n, -1)
    out, parts, idxs = [], [], []
    for s, x in zip(mesh.shards, xs):
        idx = _index(gd[s], x.device)
        cols = to_cols(x)
        part = torch.zeros(ndof, cols.shape[1], dtype=x.dtype, device=x.device)
        parts.append(part.index_add_(0, idx, cols))
        idxs.append(idx)
    for x, r, total, idx in zip(xs, rsps, mesh.psum(parts), idxs):
        out.append(_lift(r, x.ndim) * from_cols(total[idx], x.shape))
    return out


def dss_project(x: torch.Tensor, gdof, ndof: int, spheremp,
                rspheremp) -> torch.Tensor:
    """Mass-weighted continuous projection:
    (sum_e spheremp*x) / (sum_e spheremp) at every shared dof."""
    return dss_scaled(_lift(spheremp, x.ndim) * x, gdof, ndof, rspheremp)


def continuity_error_t(x: torch.Tensor, gdof, rows: int = 0) -> float:
    """max |x - x at the first alias of the same dof| over a transposed
    [k, E16] field (lane e*16 + i*4 + j): 0 exactly when every alias of
    every dof holds the same value. ``rows`` > 0 reads x that many rows at
    a time (its temporaries are then two such blocks, not two copies of
    x)."""
    g = _host(gdof).reshape(-1)
    first = np.unique(g, return_index=True)[1]
    canon = torch.from_numpy(first[g].astype(np.int64)).to(x.device)
    blocks = x.split(rows) if rows > 0 else (x,)
    return max(float((b - b[:, canon]).abs().max()) for b in blocks)
