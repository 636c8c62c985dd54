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
    ``row_tracer_plan`` is its launch plan: float4 columns (four levels of a
    tracer a thread) where nlev % 4 == 0, else scalar columns, and the
    tracers a block walks.
  * ``euler_step_fast`` is the full-state wrapper (``euler_step_pallas``,
    :93-113): qdp [nelem, qsize, nlev, np, np] packed to
    [E16, qsize*nlev], one launch, unpacked to the shape it was given.

The plain version is the [qsize*nlev, E16] advection of ``tracer_t``
(``_advect_plain``) on transposed views. ``euler_packed_emulated`` repeats
the kernel on the CPU for the tests: its arithmetic is the t-layout
kernel's (``tracer_t._advect_emulated``, bit for bit on the transposed
problem) and its grid ``row_tracer_plan``'s, every entry written once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import NP, NPSQ, Config
from ..constants import CONSTANTS
from ..device import resolve_device
from ..grid import Geometry
from . import _build
from .layout import META_COLS, pack_field, pack_meta
from .tracer_t import _advect_emulated, _advect_plain

__all__ = ["RowTracerPlan", "euler_packed", "euler_packed_emulated",
           "euler_packed_plain", "euler_step_fast", "row_tracer_plan"]

ROW_QUADS = 32          # quads (4 threads, an element's 16 points) a block
ROW_QUADS_NARROW = 64   # the same with scalar columns
ROW_TRACERS = 4         # most tracers a block walks


class RowTracerPlan(NamedTuple):
    """Launch plan of ``tracer_row_kernel``: ``vec`` contiguous columns (levels
    of one tracer) a thread, ``groups`` = nlev / vec level groups an element
    (a quad each), ``quads`` in all, ``tracers`` a block of the ``chunks``
    that split the nq tracers, ``threads`` a block, ``blocks``."""
    vec: int
    groups: int
    quads: int
    tracers: int
    chunks: int
    threads: int
    blocks: int


def row_tracer_plan(nlev: int, nq: int, ncol: int,
                    vec: int | None = None) -> RowTracerPlan:
    """The row kernel's plan for q [ncol, nq*nlev]: float4 columns where
    nlev % 4 == 0, scalar columns otherwise (``vec`` asks for one: 4 at
    nlev % 4 != 0 raises); the tracers split into the fewest chunks of at
    most ROW_TRACERS, as even as they go, so a qsize-35 launch is 9 chunks
    of 4 (3 in the last): a block's wind products paid once for 4 tracers,
    the chunks of one quad block neighbours in the launch order, so the
    winds they share come from L2, and 27,342 blocks at ne30 fill their
    waves (on the H100 4 tracers a block took 0.6356 ms, 7 0.6518, all 35
    0.7221)."""
    if nlev < 1 or nq < 1 or ncol < 16 or ncol % 16:
        raise ValueError(f"row_tracer_plan: nlev {nlev}, nq {nq}, ncol {ncol}"
                         ": needs nlev, nq >= 1 and ncol a multiple of 16")
    if vec is None:
        vec = 4 if nlev % 4 == 0 else 1
    if vec not in (1, 4):
        raise ValueError(f"row_tracer_plan: vec {vec} is not 1 or 4")
    if nlev % vec:
        raise ValueError(f"row_tracer_plan: float4 columns need nlev % 4 "
                         f"== 0, got nlev {nlev}")
    groups = nlev // vec
    quads = ncol // NPSQ * groups
    chunks = -(-nq // ROW_TRACERS)
    tracers = -(-nq // chunks)
    chunks = -(-nq // tracers)
    per_block = ROW_QUADS if vec == 4 else ROW_QUADS_NARROW
    return RowTracerPlan(vec, groups, quads, tracers, chunks, 4 * per_block,
                         -(-quads // per_block) * chunks)


def _check_row_aligned(plan: RowTracerPlan, **ops):
    """meta and dvv are read by float4, q, out and the winds by columns of
    ``plan.vec`` floats: each aligned to its read, or ValueError."""
    for op, t in ops.items():
        align = 16 if op in ("meta", "dvv") else 4 * plan.vec
        if t.data_ptr() % align:
            raise ValueError(f"euler_packed: {op} must be {align}-byte "
                             "aligned")


def euler_packed_plain(meta, vu, vv, qdp, dvv, dt, nlev: int):
    """Plain PyTorch ``euler_packed``: qdp - dt*div(v*qdp) on the row
    layout. Pure."""
    out, _ = _advect_plain(meta.T, vu.T, vv.T, qdp.T, dvv, dt, nlev, (0, 0))
    return out.T.contiguous()


def euler_packed_emulated(meta, vu, vv, qdp, dvv, dt, nlev: int,
                          plan: RowTracerPlan | None = None):
    """``euler_packed`` as ``tracer_row_kernel`` computes it, on float32 CPU
    tensors: the t-layout kernel's arithmetic on the transposed problem,
    written out by the row kernel's grid under ``plan`` (default
    ``row_tracer_plan``'s). Block b takes chunk b % chunks of the tracers
    and quads (b // chunks)*Q.. of Q = threads / 4 (the live ones: quad =
    element*groups + level group); thread li of a quad writes the points
    li*4 .. li*4+3 of its element at the group's vec levels of each tracer
    of the chunk. Returns (out, writes); entries never written stay NaN."""
    ncol, qk = qdp.shape
    nq = qk // nlev
    plan = plan or row_tracer_plan(nlev, nq, ncol)
    e = _advect_emulated(meta.T, vu.T, vv.T, qdp.T, dvv, dt, nlev, (0, 0))
    result = e.reshape(qk, ncol).T
    out = torch.full_like(result, float("nan"))
    writes = torch.zeros(ncol, qk, dtype=torch.int64)
    per_block = plan.threads // 4
    for b in range(plan.blocks):
        chunk = b % plan.chunks
        quad = b // plan.chunks * per_block + torch.arange(per_block)
        quad = quad[quad < plan.quads]
        el, grp = quad // plan.groups, quad % plan.groups
        n = torch.arange(chunk * plan.tracers,
                         min((chunk + 1) * plan.tracers, nq))
        rows = (el[:, None] * NPSQ + torch.arange(NPSQ)).reshape(-1, 1)
        cols = (n[:, None] * nlev + torch.arange(plan.vec)).reshape(1, 1, -1)
        cols = (cols + (grp * plan.vec)[:, None, None]).repeat_interleave(
            NPSQ, 0).reshape(rows.shape[0], -1)
        out[rows, cols] = result[rows, cols]
        writes[rows, cols] += 1
    return out, writes


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
    ncol, nq = qdp.shape[0], qdp.shape[1] // nlev
    plan = row_tracer_plan(nlev, nq, ncol)
    out = torch.empty_like(qdp)
    _check_row_aligned(plan, meta=meta, dvv=dvv, vu=vu, vv=vv, qdp=qdp,
                       out=out)
    err = _build.library("tracer").tracer_row_launch(
        meta.data_ptr(), dvv.data_ptr(), vu.data_ptr(), vv.data_ptr(),
        qdp.data_ptr(), out.data_ptr(), nlev, nq, ncol, plan.vec,
        plan.tracers, float(dt), CONSTANTS.rrearth,
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
