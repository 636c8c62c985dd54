"""The conservative vertical remap as one CUDA kernel (``csrc/remap.cu``;
its note gives the algorithm and the design for the card). It replaces the
JAX package's array code ``dist/step_pallas.py:693 remap_packed_t4`` over
``ops/remap.py:68 remap_column``, which has no ``pallas_call``.

  * ``remap_packed_cuda``: the packed remap of the stacked state s [4*nlev,
    E16] and tracers qdp [qsize*nlev, E16] in one launch: the target layers
    dp_tgt from the hybrid coordinate and the column totals (bit for bit
    the plain code's dp rows), u, v and T remapped as densities and every
    tracer as qdp / dp_src, its output the target cell's mass. No mass
    fixer: ``dist.remap_packed_t4`` runs it after the kernel.
  * ``remap_levels_cuda``: fields q [F*nlev, C] (densities) from dp_src to
    a given dp_tgt [nlev, C], one launch for all F.

Both take float32 or float64 and a scheme ``pcm``, ``plm`` or ``ppm``. Every
operand must have one dtype (a mixed call raises ``ValueError``; nothing is
cast) and be contiguous. CPU tensors take the plain versions
(``remap_packed_plain``, ``ops.remap.remap_levels_plain`` a field at a
time); CUDA tensors launch the kernel, counted in ``<wrapper>.launches``
(and the float64 launches in ``<wrapper>.f64_launches``).

``remap_walk_emulated`` and ``remap_packed_emulated`` compute what the
kernel computes, in its order of operations, with torch on any device: the
CPU tests hold the kernel's algorithm through them against the JAX package.
Nothing else calls them.
"""
from __future__ import annotations

import torch

from ..ops.remap import (
    _match_column_total, comp_sum, reference_dp, remap_levels_plain)
from . import _build

__all__ = ["SCHEMES", "remap_plan", "remap_packed_plain",
           "remap_packed_cuda", "remap_levels_cuda", "remap_walk_emulated",
           "remap_packed_emulated"]

SCHEMES = ("pcm", "plm", "ppm")
# dynamic shared memory a block may take on the H100 (csrc/remap.cu)
MAX_SMEM = 232448
COLS = 32                      # columns (threads) a block of the kernel


def remap_plan(nlev: int, itemsize: int, scheme: str) -> int:
    """Shared memory a block of the kernel takes (``remap_smem_bytes`` in
    csrc/remap.cu): the block's 2*nlev hybrid terms, and for each of its 32
    columns dp_src, the field, the scheme's coefficients (plm 1, ppm 2
    arrays) and the target interfaces' local coordinates and cells; raises
    where it exceeds a block's."""
    ncoef = SCHEMES.index(scheme)
    per_col = ((3 + ncoef) * nlev + 1) * itemsize + (nlev + 1) * 2
    smem = -(-(2 * nlev * itemsize + per_col * COLS) // 8) * 8
    if nlev < 1 or smem > MAX_SMEM:
        raise ValueError(f"remap: {nlev} levels of {itemsize}-byte values "
                         f"({scheme}) do not fit the kernel's shared memory")
    return smem


def remap_packed_plain(s: torch.Tensor, qdp: torch.Tensor, hv, nlev: int,
                       qsize: int, scheme: str = "plm"):
    """The packed remap without the fixer in plain PyTorch (the dense
    overlap of ``ops.remap``), on any device; hv is moved to s's device and
    may have another dtype. Returns new (s', qdp')."""
    k = nlev
    dp_src, hv = s[3 * k:4 * k], hv.to(s.device)
    # compensated level sum and column-total renormalisation: the f32
    # hybrid reconstruction's bias would drift the air mass linearly
    ps = hv.hyai[0] * hv.ps0 + comp_sum(dp_src, 0)
    # ps [E16] read as one [1, E16] "element": reference_dp gives [k, 1, E16]
    dp_ref = reference_dp(hv, ps[None]).reshape(k, -1)
    dp_tgt = _match_column_total(dp_ref, dp_src, axis=0).to(s.dtype)

    def rmp(x):
        return remap_levels_plain(x, dp_src, dp_tgt, scheme).to(s.dtype)

    s_new = torch.cat([rmp(s[i * k:(i + 1) * k]) for i in range(3)]
                      + [dp_tgt])
    q_new = torch.cat([(rmp(qdp[i * k:(i + 1) * k] / dp_src) * dp_tgt)
                       .to(s.dtype) for i in range(qsize)])
    return s_new, q_new


def _check(name, scheme, dtype, ops: dict):
    """The wrappers' operand checks; ``ops`` maps names to (tensor, shape).
    Returns the device."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown remap scheme {scheme!r}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: needs float32 or float64, got {dtype}")
    dev = next(iter(ops.values()))[0].device
    for op, (t, shape) in ops.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {op} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: {op} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {op} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _count(wrapper, dtype):
    wrapper.launches += 1
    if dtype == torch.float64:
        wrapper.f64_launches += 1


def remap_packed_cuda(s: torch.Tensor, qdp: torch.Tensor, hv, nlev: int,
                      qsize: int, scheme: str = "plm"):
    """The packed remap (no fixer) of s [4*nlev, C] and qdp [qsize*nlev, C]
    in one launch of the kernel; hv's hyai and hybi in s's dtype. Returns
    new (s', qdp')."""
    k, ncol = nlev, s.shape[-1]
    hv = hv.to(s.device)
    dev = _check("remap_packed", scheme, s.dtype, {
        "s": (s, (4 * k, ncol)), "qdp": (qdp, (qsize * k, ncol)),
        "hyai": (hv.hyai, (k + 1,)), "hybi": (hv.hybi, (k + 1,))})
    if dev.type == "cpu":
        return remap_packed_plain(s, qdp, hv, nlev, qsize, scheme)
    remap_plan(k, s.element_size(), scheme)
    s_out, q_out = torch.empty_like(s), torch.empty_like(qdp)
    err = _build.library("remap").remap_packed_launch(
        int(s.dtype == torch.float64), SCHEMES.index(scheme), s.data_ptr(),
        qdp.data_ptr(), hv.hyai.data_ptr(), hv.hybi.data_ptr(),
        float(hv.ps0), s_out.data_ptr(), q_out.data_ptr(), k, qsize, ncol,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check_launch("remap", err)
    _count(remap_packed_cuda, s.dtype)
    return s_out, q_out


remap_packed_cuda.launches = 0
remap_packed_cuda.f64_launches = 0


def remap_levels_cuda(q: torch.Tensor, dp_src: torch.Tensor,
                      dp_tgt: torch.Tensor, scheme: str = "plm"
                      ) -> torch.Tensor:
    """F fields q [F*nlev, C] (densities) remapped from dp_src to dp_tgt
    [nlev, C], equal column totals, in one launch of the kernel. Returns
    a new [F*nlev, C]."""
    k, ncol = dp_src.shape if dp_src.dim() == 2 else (0, 0)
    if k < 1 or q.dim() != 2 or q.shape[0] % k:
        raise ValueError(f"remap_levels: q must be [F*nlev, C] over dp "
                         f"[nlev, C], got {tuple(q.shape)} and "
                         f"{tuple(dp_src.shape)}")
    dev = _check("remap_levels", scheme, q.dtype, {
        "q": (q, (q.shape[0], ncol)), "dp_src": (dp_src, (k, ncol)),
        "dp_tgt": (dp_tgt, (k, ncol))})
    if dev.type == "cpu":
        return torch.cat([remap_levels_plain(x, dp_src, dp_tgt, scheme)
                          for x in q.split(k)])
    remap_plan(k, q.element_size(), scheme)
    out = torch.empty_like(q)
    err = _build.library("remap").remap_levels_launch(
        int(q.dtype == torch.float64), SCHEMES.index(scheme), q.data_ptr(),
        dp_src.data_ptr(), dp_tgt.data_ptr(), out.data_ptr(), k,
        q.shape[0] // k, ncol, torch.cuda.current_stream(dev).cuda_stream,
        dev.index)
    _build.check_launch("remap", err)
    _count(remap_levels_cuda, q.dtype)
    return out


remap_levels_cuda.launches = 0
remap_levels_cuda.f64_launches = 0


# -- the kernel's algorithm in torch (tests only) -----------------------------

def _clip(x, hi):
    return torch.minimum(torch.clamp(x, min=0.0), hi)


def _coefficients(q, dp, scheme):
    """Each source cell's reconstruction as the kernel's coefficient pass
    computes it, [K, C] each: pcm (q,), plm (q, m), ppm (q, aL, aR)."""
    k = q.shape[0]
    if scheme == "pcm":
        return (q,)
    if scheme == "plm":
        g = (q[1:] - q[:-1]) / (0.5 * (dp[1:] + dp[:-1]))
        zero = torch.zeros_like(q[:1])
        g_lo, g_hi = torch.cat([zero, g]), torch.cat([g, zero])
        m = torch.where(g_lo * g_hi > 0.0,
                        torch.copysign(torch.minimum(g_lo.abs(), g_hi.abs()),
                                       g_lo), torch.zeros_like(q))
        return q, m
    at = lambda i: q[torch.clamp(torch.arange(i, i + k + 1), 0, k - 1)]
    qm2, qm1, qp0, qp1 = at(-2), at(-1), at(0), at(1)   # edges 0..K
    e = (7.0 / 12.0) * (qm1 + qp0) - (1.0 / 12.0) * (qm2 + qp1)
    e = torch.minimum(torch.maximum(e, torch.minimum(qm1, qp0)),
                      torch.maximum(qm1, qp0))
    a_l, a_r = e[:-1], e[1:]
    ext = (a_r - q) * (q - a_l) <= 0.0
    a_l, a_r = torch.where(ext, q, a_l), torch.where(ext, q, a_r)
    d = a_r - a_l
    dev = q - 0.5 * (a_l + a_r)
    a_l = torch.where(d * dev > d * d / 6.0, 3.0 * q - 2.0 * a_r, a_l)
    a_r = torch.where(-(d * d) / 6.0 > d * dev, 3.0 * q - 2.0 * a_l, a_r)
    return q, a_l, a_r


def _piece(scheme, cf, a, b, dp):
    """Integral of the cell's reconstruction over [a, b] of [0, dp]."""
    if scheme == "pcm":
        return cf[0] * (b - a)
    if scheme == "plm":
        q, m = cf
        return (b - a) * (q + m * (0.5 * (a + b) - 0.5 * dp))
    q, al, ar = cf
    da, a6 = ar - al, 6.0 * (q - 0.5 * (al + ar))
    xa, xb = a / dp, b / dp
    return (b - a) * (al + (da + a6) * (0.5 * (xa + xb))
                      - a6 * (xa * xa + xa * xb + xb * xb) / 3.0)


def _geometry(dp_src, dp_tgt):
    """The kernel's geometry pass on [K, C] columns: for every target
    interface t_j (running sums in float64) the first source cell c_j whose
    local coordinate clip(t_j - s_c, 0, dp_c) is below dp_c (K past the
    end) and that coordinate a_j in dp_src's dtype; t_K is the column's
    end. Returns (c [K+1, C] long, a [K+1, C])."""
    k, ncol = dp_src.shape
    f64 = torch.float64
    c = torch.zeros(k + 1, ncol, dtype=torch.long, device=dp_src.device)
    a = torch.zeros(k + 1, ncol, dtype=dp_src.dtype, device=dp_src.device)
    s = torch.zeros(ncol, dtype=f64, device=dp_src.device)
    t = torch.zeros_like(s)
    cell = c[0].clone()
    for j in range(1, k):
        t = t + dp_tgt[j - 1].to(f64)
        aj = torch.zeros_like(a[0])
        active = cell < k
        while bool(active.any()):
            d = dp_src.gather(0, cell.clamp(max=k - 1)[None])[0]
            x = _clip(t - s, d.to(f64)).to(a.dtype)
            aj = torch.where(active & (x < d), x, aj)
            adv = active & (x >= d)
            s = torch.where(adv, s + d.to(f64), s)
            cell = torch.where(adv, cell + 1, cell)
            active = adv & (cell < k)
        c[j], a[j] = cell, aj
    c[k] = k
    return c, a


def remap_walk_emulated(q: torch.Tensor, dp_src: torch.Tensor,
                        dp_tgt: torch.Tensor, scheme: str = "plm",
                        mass: bool = False) -> torch.Tensor:
    """The kernel on [K, C] columns, vectorised over columns: the geometry
    pass, the coefficient pass, then for every target cell j the pieces of
    its source cells c_j .. c_{j+1} top to bottom, a whole cell as q*dp;
    the last target takes the rest of the column. dp_tgt may be float64
    for float32 q (the packed kernel's layers). Returns each target cell's
    mean (its mass over dp_tgt rounded to q's dtype), or with ``mass`` its
    mass."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown remap scheme {scheme!r}")
    k = q.shape[0]
    c, a = _geometry(dp_src, dp_tgt)
    cf = _coefficients(q, dp_src, scheme)
    take = lambda x, i: x.gather(0, i.clamp(max=k - 1)[None])[0]
    piece = lambda i, lo, hi: _piece(scheme, [take(x, i) for x in cf], lo,
                                     hi, take(dp_src, i))
    out = torch.empty_like(q)
    for j in range(k):
        c0, a0, c1, a1 = c[j], a[j], c[j + 1], a[j + 1]
        same = c1 == c0
        acc = torch.where(same & (c0 < k) & (a1 > a0), piece(c0, a0, a1),
                          torch.zeros_like(a0))
        d0 = take(dp_src, c0)
        top = torch.where(a0 == 0.0, take(q, c0) * d0, piece(c0, a0, d0))
        acc = torch.where(same, acc, top)
        cell = c0 + 1
        mid = ~same & (cell < c1)
        while bool(mid.any()):
            acc = torch.where(mid, acc + take(q, cell) * take(dp_src, cell),
                              acc)
            cell = cell + 1
            mid = mid & (cell < c1)
        bot = ~same & (c1 < k) & (a1 > 0.0)
        acc = torch.where(bot, acc + piece(c1, torch.zeros_like(a1), a1), acc)
        out[j] = acc if mass else acc / dp_tgt[j].to(q.dtype)
    return out


def remap_packed_emulated(s: torch.Tensor, qdp: torch.Tensor, hv, nlev: int,
                          qsize: int, scheme: str = "plm"):
    """The packed kernel in torch: the dp rows by the kernel's operations in
    s's dtype (the compensated totals, ps, dp_ref from the hybrid terms, the
    ratio), the same chain in float64 from the same rounded terms for the
    layers the walk remaps onto, then the walk of u, v, T as densities and
    of every tracer (qdp / dp_src) as masses. Returns (s', qdp')."""
    k, f64 = nlev, torch.float64
    dp = s[3 * k:4 * k]
    hyai, hybi, ps0 = hv.hyai, hv.hybi, hv.ps0
    da, db = ((hyai[1:] - hyai[:-1]) * ps0)[:, None], (hybi[1:] - hybi[:-1])
    ptop = hyai[0] * ps0

    def layers(x):
        tot = comp_sum(x, 0)
        ps = ptop.to(x.dtype) + tot
        ref = da.to(x.dtype) + db.to(x.dtype)[:, None] * ps
        return ref * (tot / comp_sum(ref, 0))

    dp_tgt, dp_walk = layers(dp), layers(dp.to(f64))
    walk = lambda x, mass: remap_walk_emulated(x, dp, dp_walk, scheme, mass)
    s_new = torch.cat([walk(x, False) for x in s[:3 * k].split(k)]
                      + [dp_tgt])
    q_new = torch.cat([walk(x / dp, True) for x in qdp.split(k)]) \
        if qsize else torch.empty_like(qdp)
    return s_new, q_new
