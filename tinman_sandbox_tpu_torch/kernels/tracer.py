"""Tracer advection on the packed row layout (counterpart of
``tinman_sandbox_tpu/kernels/tracer_pallas.py``).

The tracers ride the contiguous axis, tracer-major: ``qdp`` is
[E16, qsize*nlev] with column j = q*nlev + level, the winds [E16, nlev],
and one launch advects every tracer:

    out = qdp - dt * div(v * qdp),
    div = (D_x(gv1) + D_y(gv2)) * rmetdet * rrearth,
    gv1 = metdet*(dinv00*vu*qdp + dinv01*vv*qdp), gv2 alike,

the winds at level j mod nlev broadcast over the tracers. No spheremp and
no DSS: the contract of ``timeloop.tracer.euler_step``.

  * ``euler_packed`` launches ``tracer_row_kernel`` of ``csrc/tracer.cu``
    (its note gives the design) for CUDA tensors, counted in
    ``euler_packed.launches``, and runs ``euler_packed_plain`` for CPU
    tensors. It replaces ``euler_step_pallas_packed`` (tracer_pallas.py:61).
  * ``euler_step_fast`` is the full-state wrapper (``euler_step_pallas``,
    :93-113): qdp [nelem, qsize, nlev, np, np] packed to
    [E16, qsize*nlev], one launch, unpacked to the shape it was given.

The plain version is the [qsize*nlev, E16] advection of ``tracer_t``
(``_advect_plain``) on transposed views.
"""
from __future__ import annotations

import torch

from ..config import NP, NPSQ, Config
from ..constants import CONSTANTS
from ..device import resolve_device
from ..grid import Geometry
from . import _build
from .layout import META_COLS, pack_field, pack_meta
from .tracer_t import _advect_plain

__all__ = ["euler_packed", "euler_packed_plain", "euler_step_fast"]


def euler_packed_plain(meta, vu, vv, qdp, dvv, dt, nlev: int):
    """Plain PyTorch ``euler_packed``: qdp - dt*div(v*qdp) on the row
    layout. Pure."""
    out, _ = _advect_plain(meta.T, vu.T, vv.T, qdp.T, dvv, dt, nlev, (0, 0))
    return out.T.contiguous()


def _check(meta, vu, vv, qdp, dvv, nlev):
    dev, dtype = qdp.device, qdp.dtype
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"euler_packed: unsupported device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"euler_packed: needs float fields, got {dtype}")
    if dev.type == "cuda" and dtype != torch.float32:
        raise TypeError("euler_packed: the CUDA kernel takes float32 only")
    if qdp.ndim != 2 or nlev < 1 or qdp.shape[1] < nlev \
            or qdp.shape[1] % nlev or qdp.shape[0] % NPSQ:
        raise ValueError(f"euler_packed: qdp must be [multiple of {NPSQ}, "
                         f"qsize*{nlev}], got {tuple(qdp.shape)}")
    e16 = qdp.shape[0]
    for name, t, shape in (("meta", meta, (e16, len(META_COLS))),
                           ("dvv", dvv, (4, 4)), ("vu", vu, (e16, nlev)),
                           ("vv", vv, (e16, nlev)),
                           ("qdp", qdp, tuple(qdp.shape))):
        if tuple(t.shape) != shape:
            raise ValueError(f"euler_packed: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"euler_packed: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"euler_packed: {name} must be contiguous")
    return dev


def euler_packed(meta, vu, vv, qdp, dvv, dt, nlev: int):
    """qdp - dt*div(v*qdp) for every tracer on the row layout (counterpart
    of ``euler_step_pallas_packed``): meta [E16, 16]; vu, vv [E16, nlev];
    qdp [E16, qsize*nlev] tracer-major; dvv [4, 4]; ``dt`` a number.
    Returns a new [E16, qsize*nlev] tensor."""
    dev = _check(meta, vu, vv, qdp, dvv, nlev)
    if dev.type == "cpu":
        return euler_packed_plain(meta, vu, vv, qdp, dvv, dt, nlev)
    out = torch.empty_like(qdp)
    err = _build.library("tracer").tracer_row_launch(
        meta.data_ptr(), dvv.data_ptr(), vu.data_ptr(), vv.data_ptr(),
        qdp.data_ptr(), out.data_ptr(), nlev, qdp.shape[1], qdp.shape[0],
        float(dt), CONSTANTS.rrearth,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check_launch("tracer", err)
    euler_packed.launches += 1
    return out


euler_packed.launches = 0


def euler_step_fast(qdp, vstar_u, vstar_v, geom: Geometry, cfg: Config, dt,
                    device="cuda"):
    """Full-state tracer step with the contract of ``timeloop.tracer.
    euler_step`` on the row layout (counterpart of ``euler_step_pallas``):
    qdp [nelem, qsize, nlev, np, np] -> the same shape advanced by -dt*div,
    f32 on ``device`` (any float dtype on the CPU)."""
    dev = resolve_device(device)
    qdp, vstar_u, vstar_v = (x.to(dev) for x in (qdp, vstar_u, vstar_v))
    geom = geom.to(dev)
    dtype = qdp.dtype if dev.type == "cpu" else torch.float32
    nelem, qsize, nlev = qdp.shape[:3]
    meta = pack_meta(geom, torch.zeros_like(geom.fcor), dtype)
    # [e, q, k, i, j] -> [e, i, j, q, k] -> [e*16, q*k]
    qp = qdp.to(dtype).permute(0, 3, 4, 1, 2).reshape(nelem * NPSQ,
                                                      qsize * nlev)
    out = euler_packed(meta, pack_field(vstar_u.to(dtype)),
                       pack_field(vstar_v.to(dtype)), qp.contiguous(),
                       geom.dvv.to(dtype).contiguous(), dt, nlev)
    out = out.reshape(nelem, NP, NP, qsize, nlev)
    return out.permute(0, 3, 4, 1, 2).contiguous()
