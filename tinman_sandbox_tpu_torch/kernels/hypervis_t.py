"""The hyperviscosity Laplacians on the packed [k, E16] layout (counterpart
of ``tinman_sandbox_tpu/kernels/hypervis_pallas_t.py``).

One pass over the (u, v, T) row blocks of a stacked field computes the weak
vector Laplacian of (u, v) in the contravariant formulation
(``ops.sphere.vlaplace_sphere_wk_contra``) and the weak scalar Laplacian of
T (``ops.sphere.laplace_simple``): spheremp-weighted residuals, to be
closed by rspheremp * DSS. It is the hot half of
``timeloop.hyperviscosity.biharmonic_wk``.

The kernel is ``csrc/hypervis.cu`` (its note gives the design). It replaces
the Pallas kernels ``vlap_pallas_packed_t`` (hypervis_pallas_t.py:144),
``vlap_pallas_packed_t_lg`` (:252) and ``vlap_pallas_packed_t_ext`` (:343),
which share the body ``_vlap_kernel_t`` (:42-139) and differ only in how the
TPU's grid cuts the lanes and lays out the fix-lane slab. Their
``fast_dots`` mode is left out on purpose of accuracy.

  * ``vlap_plain`` is the same function in plain PyTorch (einsums over
    ``dvv``), metinv rebuilt from Dinv as in the kernel.
  * ``vlap_cuda`` checks its operands, runs the plain version for CPU
    tensors and launches the kernel for CUDA tensors (float32), counted in
    ``vlap_cuda.launches``.
  * Both read only the first three nlev-row blocks of ``x``, which may be
    taller (the full [4*nlev] prognostic buffer), and with ``fix=`` (the
    fix-lane tables of ``kernels/dss.py``) also return the slab
    [nfix, 3*nlev] with ``slab[r] = out[:, read_lanes[r]]``.
"""
from __future__ import annotations

import torch

from ..config import NPSQ
from ..constants import CONSTANTS
from ..ops.sphere import full_precision_matmuls
from ..profiling import launch_span
from . import _build
from .layout import META_COLS

__all__ = ["vlap_plain", "vlap_cuda"]

_MC = {name: i for i, name in enumerate(META_COLS)}


def vlap_plain(meta, x, dvv, nlev: int, nu_ratio=1.0, fix=None):
    """Plain PyTorch weak Laplacians of the (u, v, T) rows of x
    [>= 3*nlev, E16]: returns out [3*nlev, E16] = (lap_u, lap_v, lap_T),
    and with ``fix`` also the slab of out at the fix lanes. Pure."""
    full_precision_matmuls()
    k = nlev
    e16 = x.shape[1]
    ne = e16 // NPSQ
    rr = CONSTANTS.rrearth
    u, v, t = x[:k], x[k:2 * k], x[2 * k:3 * k]

    def row(name):
        return meta[_MC[name]]                       # [E16], broadcast on k

    def el(s):
        return s.reshape(k, ne, 4, 4)

    def dx(s):
        return torch.einsum("il,keij->kelj", dvv, el(s)).reshape(k, e16)

    def dy(s):
        return torch.einsum("keji,il->kejl", el(s), dvv).reshape(k, e16)

    def ax(s):
        return torch.einsum("ms,kesn->kemn", dvv, el(s)).reshape(k, e16)

    def ay(s):
        return torch.einsum("kems,ns->kemn", el(s), dvv).reshape(k, e16)

    dinv00, dinv01 = row("dinv00"), row("dinv01")
    dinv10, dinv11 = row("dinv10"), row("dinv11")
    d00, d01, d10, d11 = row("d00"), row("d01"), row("d10"), row("d11")
    metdet, rmetdet = row("metdet"), row("rmetdet")
    sph, mp = row("spheremp"), row("mp")
    # metinv = Dinv Dinv^T (the contravariant metric)
    mi00 = dinv00 * dinv00 + dinv01 * dinv01
    mi01 = dinv00 * dinv10 + dinv01 * dinv11
    mi11 = dinv10 * dinv10 + dinv11 * dinv11

    # scalar: laplace_simple(T) = div_wk(grad(T))
    v1, v2 = dx(t) * rr, dy(t) * rr
    g1 = dinv00 * v1 + dinv10 * v2
    g2 = dinv01 * v1 + dinv11 * v2
    c1 = dinv00 * g1 + dinv01 * g2
    c2 = dinv10 * g1 + dinv11 * g2
    lap_t = -rr * (ax(sph * c1) + ay(sph * c2))

    # vector: vlaplace_sphere_wk_contra(u, v)
    gv1 = metdet * (dinv00 * u + dinv01 * v)
    gv2 = metdet * (dinv10 * u + dinv11 * v)
    div = (dx(gv1) + dy(gv2)) * (rmetdet * rr)
    vco1 = d00 * u + d10 * v
    vco2 = d01 * u + d11 * v
    vort = (dx(vco2) - dy(vco1)) * (rmetdet * rr)
    xg = mp * (nu_ratio * div)
    axg, ayg = ax(xg), ay(xg)
    b0 = -metdet * (mi00 * axg + mi01 * ayg)
    b1 = -metdet * (mi01 * axg + mi11 * ayg)
    gw1 = (d00 * b0 + d01 * b1) * rr
    gw2 = (d10 * b0 + d11 * b1) * rr
    xc = mp * vort
    c0, c1c = -ay(xc), ax(xc)
    cw1 = (d00 * c0 + d01 * c1c) * rr
    cw2 = (d10 * c0 + d11 * c1c) * rr
    rigid = (2.0 * rr * rr) * sph
    out = torch.cat([rigid * u + (gw1 - cw1), rigid * v + (gw2 - cw2), lap_t])
    if fix is None:
        return out
    return out, out[:, fix.read_lanes.long()].T.contiguous()


def _check(meta, x, dvv, nlev):
    """Validate the operands of one vlap call; returns the device."""
    dev, dtype = x.device, x.dtype
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"vlap: unsupported device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vlap: needs float fields, got {dtype}")
    if dev.type == "cuda" and dtype != torch.float32:
        raise TypeError("vlap: the CUDA kernel takes float32 only")
    if x.ndim != 2 or nlev < 1 or x.shape[0] < 3 * nlev \
            or x.shape[0] % nlev or x.shape[1] % NPSQ:
        raise ValueError(f"vlap: x must be [m*{nlev} >= {3 * nlev}, "
                         f"multiple of {NPSQ}], got {tuple(x.shape)}")
    e16 = x.shape[1]
    for name, t, shape in (("meta", meta, (len(META_COLS), e16)),
                           ("dvv", dvv, (4, 4)), ("x", x, tuple(x.shape))):
        if tuple(t.shape) != shape:
            raise ValueError(f"vlap: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"vlap: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"vlap: {name} must be contiguous")
    return dev


@launch_span
def vlap_cuda(meta, x, dvv, nlev: int, nu_ratio=1.0, fix=None):
    """Weak (vlaplace_u, vlaplace_v, laplace_T) of the (u, v, T) rows of the
    stacked field x [>= 3*nlev, E16] (counterpart of
    ``vlap_pallas_packed_t`` and, with ``fix``, of its slab-emitting forms
    ``_lg`` and ``_ext``). meta [16, E16]; dvv [4, 4]; ``nu_ratio`` a
    number (hpp:938 nu_div/nu). Returns out [3*nlev, E16], and with ``fix``
    also the fix-lane slab [nfix, 3*nlev]."""
    dev = _check(meta, x, dvv, nlev)
    if dev.type == "cpu":
        return vlap_plain(meta, x, dvv, nlev, nu_ratio, fix)
    e16 = x.shape[1]
    out = torch.empty(3 * nlev, e16, dtype=x.dtype, device=dev)
    slab, rank = None, None
    if fix is not None:
        rank = fix.fix_rank
        if rank.device != dev or rank.dtype != torch.int32 \
                or tuple(rank.shape) != (e16,):
            raise ValueError(f"vlap: fix_rank must be int32 [{e16}] on "
                             f"{dev}, got {rank.dtype} {tuple(rank.shape)} "
                             f"on {rank.device}")
        slab = torch.empty(fix.nfix, 3 * nlev, dtype=x.dtype, device=dev)
    err = _build.library("hypervis").hypervis_vlap_launch(
        meta.data_ptr(), dvv.data_ptr(), x.data_ptr(), out.data_ptr(),
        0 if rank is None else rank.data_ptr(),
        0 if slab is None else slab.data_ptr(), nlev, e16, e16,
        float(nu_ratio), CONSTANTS.rrearth,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check_launch("hypervis", err)
    vlap_cuda.launches += 1
    return out if fix is None else (out, slab)


vlap_cuda.launches = 0
