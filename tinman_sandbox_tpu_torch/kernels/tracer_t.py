"""Tracer advection on the packed [qsize*nlev, E16] layout (counterpart of
``tinman_sandbox_tpu/kernels/tracer_pallas_t.py``).

All tracers ride the row axis, tracer-major (row = q*nlev + level), and one
launch advects every tracer: per row

    e = q - dt * div(v * q),   div = (D_x(gv1) + D_y(gv2)) * rmetdet * rrearth,
    gv1 = metdet*(dinv00*vu*q + dinv01*vv*q), gv2 alike,

with spheremp folded into the output, so that the structured DSS
(``kernels/dss.py``) completes the continuous projection
rspheremp * DSS(spheremp * x) without another pass.

The two kernels are ``csrc/tracer.cu`` (its note gives the design):

  * ``tracer_euler_cuda``: ``sph * e`` (or ``e`` with ``fold_sph=False``).
    It replaces ``tracer_euler_pallas_packed_t`` (tracer_pallas_t.py:404),
    ``tracer_euler_pallas_packed_t_lg`` (:507) and
    ``tracer_euler_pallas_packed_t_ext`` (:674), which share the body
    ``_tracer_kernel_t`` (:195-251) and differ in how the TPU's grid cuts
    the lanes and rows and lays out the fix-lane slab.
  * ``tracer_limit_cuda``: the fused limited stage ``sph * L(y, bounds(q))``
    with ``y = e`` or, with ``mix=(mx, ca, cb)``, the Shu-Osher combination
    ``ca*mx + cb*e``. It replaces ``tracer_limit_pallas_packed_t_ext``
    (:322), body ``_tracer_limit_kernel_t`` (:254-317). L is the monotone
    mass-conserving limiter in the kernel form ``_limit_lanes`` (:145-192):
    bounds from the extrema of the stage INPUT q over each element's 16
    lanes, weights spheremp, the deficit as the sum of the clipped-off
    amounts (never a difference of two masses), redistribution into the room
    toward the bound the deficit's sign selects, and a final uniform
    residual pass. It is another formulation than the field form
    ``ops.limiter.limit_tracer`` and agrees with it to ~2e-4 in f32.

Each has a plain PyTorch version (``tracer_euler_plain``,
``tracer_limit_plain``). The wrappers check their operands, run the plain
version for CPU tensors (any float dtype) and launch the kernel for CUDA
tensors (float32), counted in ``<wrapper>.launches`` (and those with a slab
output also in ``<wrapper>.slab_launches``). The compute dtype is the
winds'; every operand holds it, but that the stages take a bf16 stage
input, as the JAX package's full step hands them its bf16 qdp under
``bench --prim --storage``: ``q`` in the Euler stage and in the limited
stage without a mix field, and the mix field ``mx`` (beside a q of the
compute dtype) in the limited stage with one. The kernels upcast it
exactly, so each such launch is bit for bit the launch on the upcast
operand, and the plain versions upcast first; out and the slab are of the
compute dtype. Such launches also count in
``<wrapper>.storage_launches``. The kernels read and write float4s: on
the card every field must be 16-byte aligned (a misaligned view raises
ValueError; nothing falls back).

``tracer_euler_emulated`` and ``tracer_limit_emulated`` repeat on the CPU
what the kernels compute and in which order (the quad layout of
``csrc/tracer.cu``: a thread = one row of an element, 4 lanes; the shared
wind-metric products c1, c2; D_x over rows li ^ m; each group sum a tree
over a thread's 4 lanes and then over the quad; a division once a thread),
with FMAs rounded once, and count the writes of the kernels' grid over
(128-lane tiles, level chunks of ``TRACER_LEVELS`` split over 4 warps in
the Euler stage and 8 in the limited stage, every tracer): the CPU tests
hold them against the JAX kernels and the plain versions.

The winds are read out of ``vu`` / ``vv`` at the nlev-row BLOCK indices
``wind_rows``: pass the stacked [4*nlev, E16] prognostic state as both with
``wind_rows=(0, 1)`` to read them in place, with no slice copy. With
``fix=`` (the fix-lane tables of ``kernels/dss.py``) both also return the
slab [nfix, qsize*nlev] with ``slab[r] = out[:, read_lanes[r]]``.
"""
from __future__ import annotations

import itertools

import torch

from ..config import NPSQ
from ..constants import CONSTANTS
from ..ops.sphere import full_precision_matmuls
from . import _build
from .layout import META_COLS

__all__ = ["TRACER_LEVELS", "TRACER_TILE", "TRACER_WARPS",
           "tracer_euler_plain", "tracer_euler_cuda", "tracer_euler_emulated",
           "tracer_limit_plain", "tracer_limit_cuda", "tracer_limit_emulated"]

_MC = {name: i for i, name in enumerate(META_COLS)}
# the grid of csrc/tracer.cu's Euler and limited kernels: a block takes
# TRACER_TILE lanes (a warp's 32 quads of 4 lanes) and TRACER_LEVELS levels
# of every tracer, split over its warps (4 in the Euler stage, 8 in the
# limited stage): warp w of W the levels w, w + W, ... of the chunk
TRACER_LEVELS = 8
TRACER_TILE = 128
TRACER_WARPS = {"euler": 4, "limit": 8}


def _advect_plain(meta, vu, vv, q, dvv, dt, nlev, wind_rows):
    """e = q - dt*div(v*q) on [qsize*nlev, E16] rows, and spheremp [E16];
    a bf16 q upcast exactly to the winds' dtype first."""
    full_precision_matmuls()
    q = q.to(vu.dtype)
    dt = float(dt)                    # a numpy scalar would take over the op
    k = nlev
    qk, e16 = q.shape
    nq, ne = qk // k, e16 // NPSQ
    wu, wv = wind_rows
    u, v = vu[wu * k:(wu + 1) * k], vv[wv * k:(wv + 1) * k]

    def row(name):
        return meta[_MC[name]]                       # [E16], broadcast on rows

    def dx(s):
        return torch.einsum("il,keij->kelj", dvv,
                            s.reshape(qk, ne, 4, 4)).reshape(qk, e16)

    def dy(s):
        return torch.einsum("keji,il->kejl", s.reshape(qk, ne, 4, 4),
                            dvv).reshape(qk, e16)

    # the winds broadcast over the tracer axis
    q3 = q.reshape(nq, k, e16)
    vq1, vq2 = (q3 * u).reshape(qk, e16), (q3 * v).reshape(qk, e16)
    metdet = row("metdet")
    gv1 = metdet * (row("dinv00") * vq1 + row("dinv01") * vq2)
    gv2 = metdet * (row("dinv10") * vq1 + row("dinv11") * vq2)
    div = (dx(gv1) + dy(gv2)) * (row("rmetdet") * CONSTANTS.rrearth)
    return q - dt * div, row("spheremp")


def _with_slab(out, fix):
    if fix is None:
        return out
    return out, out[:, fix.read_lanes.long()].T.contiguous()


def tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev: int,
                       fold_sph: bool = True, wind_rows=(0, 0), fix=None):
    """Plain PyTorch ``tracer_euler_cuda``: spheremp * (q - dt*div(v*q)),
    or without the spheremp factor; with ``fix`` also the slab. Pure."""
    adv, sph = _advect_plain(meta, vu, vv, q, dvv, dt, nlev, wind_rows)
    return _with_slab(sph * adv if fold_sph else adv, fix)


def _limit_lanes_plain(y, q_in, w, iters: int):
    """``_limit_lanes`` of the JAX package as its interpret mode computes
    it: y, q_in [rows, E16]; w [E16]. Group = the 16 lanes of an element."""
    rows, e16 = y.shape
    nel = e16 // NPSQ
    tiny = torch.finfo(y.dtype).tiny

    def gsum(x):
        return x.reshape(-1, nel, NPSQ).sum(2)

    def lanes(s):
        return s.repeat_interleave(NPSQ, dim=1)

    q3 = q_in.reshape(rows, nel, NPSQ)
    qminb, qmaxb = lanes(q3.amin(2)), lanes(q3.amax(2))
    mass = gsum(w * y)
    wsum = gsum(w[None])
    carry = torch.zeros_like(mass)
    for _ in range(iters):
        yc = torch.minimum(torch.maximum(y, qminb), qmaxb)
        d = gsum(w * (y - yc)) + carry
        pos = d > 0
        posb = lanes(pos)
        room = torch.where(posb, qmaxb - yc, yc - qminb)
        tot = gsum(w * room)
        give = torch.where(pos, torch.minimum(d, tot), torch.maximum(d, -tot))
        carry = d - give
        c = give / tot.clamp(min=tiny)               # signed coefficient
        bsel = torch.where(posb, qmaxb, qminb)
        y = yc + lanes(c.abs()) * (bsel - yc)
    # exact-conservation fallback: spread the residual uniformly by weight
    return y + lanes((mass - gsum(w * y)) / wsum)


def _mix_of(name, q, mix):
    """Validate ``mix=(mx, ca, cb)`` against q; (mx, ca, cb) with the
    coefficients as Python floats (a float32 value converts exactly)."""
    if mix is None:
        return None, 0.0, 0.0
    mx, ca, cb = mix
    if tuple(mx.shape) != tuple(q.shape):
        raise ValueError(f"{name}: mix field must be {tuple(q.shape)}, got "
                         f"{tuple(mx.shape)}")
    return mx, float(ca), float(cb)


def tracer_limit_plain(meta, vu, vv, q, dvv, dt, nlev: int, mix=None,
                       wind_rows=(0, 0), iters: int = 2, fix=None):
    """Plain PyTorch ``tracer_limit_cuda``: sph * L(y, bounds(q)) with
    y = q - dt*div(v*q), or ca*mx + cb*that with ``mix=(mx, ca, cb)``; with
    ``fix`` also the slab. Pure."""
    mx, ca, cb = _mix_of("tracer_limit", q, mix)
    y, sph = _advect_plain(meta, vu, vv, q, dvv, dt, nlev, wind_rows)
    if mx is not None:
        y = ca * mx.to(y.dtype) + cb * y
    return _with_slab(sph * _limit_lanes_plain(y, q.to(y.dtype), sph, iters),
                      fix)


def _check(name, meta, vu, vv, q, dvv, nlev, wind_rows, mx=None, bf16=()):
    """Validate the operands of one tracer launch; returns the device. The
    compute dtype is q's (vu's where q is bf16), which every operand holds
    but those named in ``bf16`` ("q", "mix field"), which may be bf16 too."""
    dev = q.device
    ref, dtype = ("vu", vu.dtype) if q.dtype == torch.bfloat16 else \
        ("q", q.dtype)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: needs float fields, got {dtype} ({ref})")
    if dev.type == "cuda" and dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 only")
    if q.ndim != 2 or nlev < 1 or q.shape[0] < nlev or q.shape[0] % nlev \
            or q.shape[1] % NPSQ:
        raise ValueError(f"{name}: q must be [qsize*{nlev}, multiple of "
                         f"{NPSQ}], got {tuple(q.shape)}")
    e16 = q.shape[1]
    wu, wv = wind_rows
    for wname, w, blk in (("vu", vu, wu), ("vv", vv, wv)):
        if w.ndim != 2 or blk < 0 or w.shape[0] < (blk + 1) * nlev \
                or w.shape[1] != e16:
            raise ValueError(f"{name}: {wname} must be [>= {(blk + 1) * nlev}"
                             f", {e16}] for wind row block {blk}, got "
                             f"{tuple(w.shape)}")
    ops = [("meta", meta, (len(META_COLS), e16)), ("dvv", dvv, (4, 4)),
           ("vu", vu, tuple(vu.shape)), ("vv", vv, tuple(vv.shape)),
           ("q", q, tuple(q.shape))]
    if mx is not None:
        ops.append(("mix field", mx, tuple(q.shape)))
    for op, t, shape in ops:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {op} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        ok = (dtype, torch.bfloat16) if op in bf16 else (dtype,)
        if t.device != dev or t.dtype not in ok:
            raise ValueError(f"{name}: {op} is {t.dtype} on {t.device}, "
                             f"expected {' or '.join(map(str, ok))} on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {op} must be contiguous")
    return dev


def _check_aligned(name, ld: int, **ops):
    """The kernels move 16-byte groups of 4 lanes: every base pointer (the
    winds' at their row block) 16-byte aligned and ld % 4 == 0, or
    ValueError. ``ops``: name -> tensor or (tensor, element offset)."""
    if ld % 4:
        raise ValueError(f"{name}: the leading dimension {ld} is not a "
                         "multiple of 4")
    for op, t in ops.items():
        t, off = t if isinstance(t, tuple) else (t, 0)
        if t is not None and (t.data_ptr() + off * t.element_size()) % 16:
            raise ValueError(f"{name}: {op} must be 16-byte aligned")


def _new_slab(name, fix, q, dtype):
    """(fix_rank pointer, slab) for ``fix``, the slab [nfix, rows of q] in
    ``dtype``."""
    if fix is None:
        return 0, None
    rank = fix.fix_rank
    if rank.device != q.device or rank.dtype != torch.int32 \
            or tuple(rank.shape) != (q.shape[1],):
        raise ValueError(f"{name}: fix_rank must be int32 [{q.shape[1]}] on "
                         f"{q.device}, got {rank.dtype} {tuple(rank.shape)} "
                         f"on {rank.device}")
    return rank.data_ptr(), torch.empty(fix.nfix, q.shape[0], dtype=dtype,
                                        device=q.device)


def tracer_euler_cuda(meta, vu, vv, q, dvv, dt, nlev: int,
                      fold_sph: bool = True, wind_rows=(0, 0), fix=None):
    """spheremp * (q - dt*div(v*q)) for the stacked [qsize*nlev, E16] tracer
    block (counterpart of ``tracer_euler_pallas_packed_t`` and, with
    ``fix``, of its slab-emitting forms ``_lg`` and ``_ext``). meta
    [16, E16]; vu, vv [>= (block+1)*nlev, E16] holding the winds at the row
    blocks ``wind_rows``; dvv [4, 4]; ``dt`` a number; q may be bf16.
    ``fold_sph=False`` returns the plain advected value. Returns out
    [qsize*nlev, E16] in the winds' dtype, and with ``fix`` also the
    fix-lane slab [nfix, qsize*nlev]."""
    dev = _check("tracer_euler", meta, vu, vv, q, dvv, nlev, wind_rows,
                 bf16=("q",))
    if dev.type == "cpu":
        return tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev, fold_sph,
                                  wind_rows, fix)
    rank, slab = _new_slab("tracer_euler", fix, q, vu.dtype)
    out = torch.empty_like(q, dtype=vu.dtype)
    bf16 = int(q.dtype == torch.bfloat16)
    e16 = q.shape[1]
    _check_aligned("tracer_euler", e16, meta=meta, dvv=dvv, q=q, out=out,
                   vu=(vu, wind_rows[0] * nlev * e16),
                   vv=(vv, wind_rows[1] * nlev * e16),
                   fix_rank=None if fix is None else fix.fix_rank)
    err = _build.library("tracer").tracer_euler_launch(
        meta.data_ptr(), dvv.data_ptr(), vu.data_ptr(), vv.data_ptr(),
        q.data_ptr(), out.data_ptr(), rank,
        0 if slab is None else slab.data_ptr(), nlev, q.shape[0] // nlev,
        e16, e16, wind_rows[0], wind_rows[1], int(bool(fold_sph)), bf16,
        float(dt), CONSTANTS.rrearth,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check_launch("tracer", err)
    tracer_euler_cuda.launches += 1
    tracer_euler_cuda.storage_launches += bf16
    if slab is None:
        return out
    tracer_euler_cuda.slab_launches += 1
    return out, slab


tracer_euler_cuda.launches = 0
tracer_euler_cuda.slab_launches = 0   # the launches among them with a slab
tracer_euler_cuda.storage_launches = 0   # and those with a bf16 q


def tracer_limit_cuda(meta, vu, vv, q, dvv, dt, nlev: int, mix=None,
                      wind_rows=(0, 0), iters: int = 2, fix=None):
    """One fused LIMITED tracer stage (counterpart of
    ``tracer_limit_pallas_packed_t_ext``): e = q - dt*div(v*q); y = e, or
    ca*mx + cb*e with ``mix=(mx, ca, cb)`` (mx of q's shape, ca and cb
    numbers); y = L(y, bounds(q)) element by element; out = spheremp * y.
    Operands as ``tracer_euler_cuda``, but that q may be bf16 only without
    ``mix``, and mx bf16 beside a q of the winds' dtype; ``iters`` >= 0
    clip-and-redistribute passes (1 conserves but may leave the bounds; 0
    runs only the final residual pass, as the JAX kernel does). Returns out
    [qsize*nlev, E16], and with ``fix`` also the slab [nfix, qsize*nlev]."""
    mx, ca, cb = _mix_of("tracer_limit", q, mix)
    if iters < 0:
        raise ValueError(f"tracer_limit: iters must be >= 0, got {iters}")
    dev = _check("tracer_limit", meta, vu, vv, q, dvv, nlev, wind_rows, mx,
                 bf16=("q",) if mx is None else ("mix field",))
    if dev.type == "cpu":
        return tracer_limit_plain(meta, vu, vv, q, dvv, dt, nlev, mix,
                                  wind_rows, iters, fix)
    rank, slab = _new_slab("tracer_limit", fix, q, vu.dtype)
    out = torch.empty_like(q, dtype=vu.dtype)
    bf16 = (2 if mx is not None and mx.dtype == torch.bfloat16
            else int(q.dtype == torch.bfloat16))
    e16 = q.shape[1]
    _check_aligned("tracer_limit", e16, meta=meta, dvv=dvv, q=q, out=out,
                   mx=mx, vu=(vu, wind_rows[0] * nlev * e16),
                   vv=(vv, wind_rows[1] * nlev * e16),
                   fix_rank=None if fix is None else fix.fix_rank)
    err = _build.library("tracer").tracer_limit_launch(
        meta.data_ptr(), dvv.data_ptr(), vu.data_ptr(), vv.data_ptr(),
        q.data_ptr(), 0 if mx is None else mx.data_ptr(), out.data_ptr(),
        rank, 0 if slab is None else slab.data_ptr(), nlev,
        q.shape[0] // nlev, e16, e16, wind_rows[0], wind_rows[1], int(iters),
        bf16, float(dt), ca, cb, CONSTANTS.rrearth,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check_launch("tracer", err)
    tracer_limit_cuda.launches += 1
    tracer_limit_cuda.storage_launches += bf16 > 0
    if slab is None:
        return out
    tracer_limit_cuda.slab_launches += 1
    return out, slab


tracer_limit_cuda.launches = 0
tracer_limit_cuda.slab_launches = 0   # the launches among them with a slab
tracer_limit_cuda.storage_launches = 0   # and those with a bf16 q or mx


# -- the kernels' walk and arithmetic on the CPU ------------------------------

def _fma(a, b, c):
    """a*b + c with one rounding to float32, as ``fmaf``: the product of two
    float32 values is exact in float64 (a rare sum may round twice)."""
    a = a.double() if torch.is_tensor(a) else float(a)
    return (a * b.double() + c.double()).float()


def _f32(x) -> float:
    """A number as the kernel's float argument receives it."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def _qsum(a):
    """A group sum as the kernels take it, on [rows, nel, 4 (li), 4 (lj)]:
    a tree over a thread's 4 lanes, then the quad's 4 partial sums by xor 1
    and xor 2. Returns [rows, nel, 1, 1]."""
    s = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])
    return ((s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3]))[..., None,
                                                                 None]


def _advect_emulated(meta, vu, vv, q, dvv, dt, nlev, wind_rows):
    """e = q - dt*div(v*q) as the kernels compute it, [rows, nel, 4, 4]."""
    rows, e16 = q.shape
    nq, nel = rows // nlev, e16 // NPSQ
    wu, wv = wind_rows
    u, v = vu[wu * nlev:(wu + 1) * nlev], vv[wv * nlev:(wv + 1) * nlev]
    m = lambda name: meta[_MC[name]]
    # the wind-metric products of a (level, lane), shared by the tracers
    c1 = m("metdet") * _fma(m("dinv00"), u, m("dinv01") * v)
    c2 = m("metdet") * _fma(m("dinv10"), u, m("dinv11") * v)
    quads = lambda x: x.reshape(rows, nel, 4, 4)
    q3 = q.reshape(nq, nlev, e16)
    g1, g2 = quads(c1 * q3), quads(c2 * q3)
    li = torch.arange(4)
    # D_x: rows li ^ m of gv1 (the quad's shuffles), m ascending
    ax = dvv[li, li].view(1, 1, 4, 1) * g1
    for s in (1, 2, 3):
        ax = _fma(dvv[li ^ s, li].view(1, 1, 4, 1), g1[:, :, li ^ s, :], ax)
    # D_y: the thread's own row
    ay = dvv[0].view(1, 1, 1, 4) * g2[..., 0:1]
    for s in (1, 2, 3):
        ay = _fma(dvv[s].view(1, 1, 1, 4), g2[..., s:s + 1], ay)
    rmr = (m("rmetdet") * _f32(CONSTANTS.rrearth)).view(1, nel, 4, 4)
    return _fma(-_f32(dt), (ax + ay) * rmr, quads(q))


def _limit_emulated(y, q, w, iters):
    """The kernels' limiter on [rows, nel, 4, 4]; w [1, nel, 4, 4]."""
    lo, hi = q.amin((2, 3), keepdim=True), q.amax((2, 3), keepdim=True)
    tiny = torch.finfo(torch.float32).tiny
    mass = _qsum(w * y)
    carry = torch.zeros_like(mass)
    for _ in range(iters):
        yc = torch.minimum(torch.maximum(y, lo), hi)
        d = _qsum(w * (y - yc)) + carry
        pos = d > 0
        tot = _qsum(w * torch.where(pos, hi - yc, yc - lo))
        give = torch.where(pos, torch.minimum(d, tot), torch.maximum(d, -tot))
        carry = d - give
        c = (give / tot.clamp(min=tiny)).abs()      # once a thread
        y = _fma(c, torch.where(pos, hi, lo) - yc, yc)
    return y + (mass - _qsum(w * y)) / _qsum(w)


def _walk(result, nlev, fix, warps):
    """Write ``result`` [rows, E16] out as the kernels' grid does: block
    (x, y) takes lanes x*TRACER_TILE.. (32 quads of 4 lanes, the live ones)
    and levels y*TRACER_LEVELS.. of every tracer, its warp w of ``warps``
    the levels w, w + warps, ...; each thread writes its 4 lanes of a row
    and, where a lane has a fix rank, the slab entry. Returns (out, slab or
    None, writes, slab writes or None); entries never written stay NaN."""
    rows, e16 = result.shape
    nq = rows // nlev
    out = torch.full_like(result, float("nan"))
    writes = torch.zeros(rows, e16, dtype=torch.int64)
    slab = swrites = rank = None
    if fix is not None:
        slab = torch.full((fix.nfix, rows), float("nan"), dtype=result.dtype)
        swrites = torch.zeros(fix.nfix, rows, dtype=torch.int64)
        rank = fix.fix_rank.long()
    for bx in range(-(-e16 // TRACER_TILE)):
        col = bx * TRACER_TILE + 4 * torch.arange(TRACER_TILE // 4)
        lanes = (col[col < e16][:, None] + torch.arange(4)).reshape(-1)
        for by, warp in itertools.product(range(-(-nlev // TRACER_LEVELS)),
                                          range(warps)):
            k0 = by * TRACER_LEVELS
            k1 = max(min(k0 + TRACER_LEVELS, nlev), k0 + warp)
            ks = torch.arange(k0 + warp, k1, warps)
            rws = (torch.arange(nq)[:, None] * nlev + ks).reshape(-1)
            idx = (rws[:, None], lanes[None])
            out[idx] = result[idx]
            writes[idx] += 1
            if fix is not None:
                fl = lanes[rank[lanes] >= 0]
                sidx = (rank[fl][:, None], rws[None])
                slab[sidx] = result[rws][:, fl].T
                swrites[sidx] += 1
    return out, slab, writes, swrites


def tracer_euler_emulated(meta, vu, vv, q, dvv, dt, nlev: int,
                          fold_sph: bool = True, wind_rows=(0, 0), fix=None):
    """``tracer_euler_cuda`` as its kernel computes it, on float32 CPU
    tensors: the quad layout's arithmetic and order, written out by the
    kernel's grid. Returns (out, slab or None, writes, slab writes or None)
    (``_walk``)."""
    e = _advect_emulated(meta, vu, vv, q, dvv, dt, nlev, wind_rows)
    if fold_sph:
        e = e * meta[_MC["spheremp"]].view(1, -1, 4, 4)
    return _walk(e.reshape(q.shape), nlev, fix, TRACER_WARPS["euler"])


def tracer_limit_emulated(meta, vu, vv, q, dvv, dt, nlev: int, mix=None,
                          wind_rows=(0, 0), iters: int = 2, fix=None):
    """``tracer_limit_cuda`` as its kernel computes it, on float32 CPU
    tensors (``tracer_euler_emulated``, then the Shu-Osher combination
    ``ca*mx + cb*e``, both products and the sum rounded, and the kernel's
    limiter). Returns (out, slab or
    None, writes, slab writes or None)."""
    mx, ca, cb = _mix_of("tracer_limit", q, mix)
    y = _advect_emulated(meta, vu, vv, q, dvv, dt, nlev, wind_rows)
    quads = lambda x: x.reshape(q.shape[0], -1, 4, 4)
    if mx is not None:
        y = _f32(ca) * quads(mx) + _f32(cb) * y
    w = meta[_MC["spheremp"]].view(1, -1, 4, 4)
    y = _limit_emulated(y, quads(q), w, iters)
    return _walk((w * y).reshape(q.shape), nlev, fix, TRACER_WARPS["limit"])
