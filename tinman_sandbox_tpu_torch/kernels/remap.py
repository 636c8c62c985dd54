"""The conservative vertical remap as one CUDA kernel (``csrc/remap.cu``;
its note gives the algorithm and the design for the card). It replaces the
JAX package's array code ``dist/step_pallas.py:693 remap_packed_t4`` over
``ops/remap.py:68 remap_column``, which has no ``pallas_call``.

  * ``remap_packed_cuda``: the packed remap of the stacked state s [4*nlev,
    E16] and tracers qdp [qsize*nlev, E16] in one launch: the target layers
    dp_tgt from the hybrid coordinate and the column totals (bit for bit
    the plain code's dp rows), u, v and T remapped as densities and every
    tracer as qdp / dp_src, its output the target cell's mass. With the
    dry-mass fixer's operands (``sph_lanes`` and ``mass_target``) it folds
    the fixer into the kernel's stores, in two launches: the fixer's ratio
    r = mass_target / ``packed_air_mass`` of the new dp rows needs every
    column's dp rows before any tracer value is stored, so launch (a) writes
    the dp rows alone, torch measures their air mass, and launch (b) remaps
    everything again with the dp rows and every tracer value stored as
    ``__fmul_rn(x, r)`` (r formed on the card by the IEEE division of the
    two device scalars; u, v, T unscaled). Launch (b) recomputes its chains
    and never reads (a)'s rows. Each stored value is the rounded product
    the fixer's ``x *= r`` made of the same value: the bits of the kernel
    followed by ``fix_mass_plain``, without the fixer's pass over the
    tracers. Counted in ``remap_packed_cuda.fixer_launches`` (calls).
  * ``remap_levels_cuda``: fields q [F*nlev, C] (densities) from dp_src to
    a given dp_tgt [nlev, C], one launch for all F.

Both take float32 or float64 and a scheme ``pcm``, ``plm`` or ``ppm``. Every
operand must have one dtype (a mixed call raises ``ValueError``; nothing is
cast) and be contiguous. CPU tensors take the plain versions
(``remap_packed_plain``, ``ops.remap.remap_levels_plain`` a field at a
time); CUDA tensors launch the kernel, counted in ``<wrapper>.launches``
(and the float64 launches in ``<wrapper>.f64_launches``).

``packed_air_mass`` is the fixer's functional and ``fix_mass_plain`` the
fixer in plain PyTorch (``dist.remap_packed_t4`` runs it after the plain
remap; the kernel's fold is held to it).

``remap_walk_emulated`` and ``remap_packed_emulated`` compute what the
kernel computes, in its order of operations, with torch on any device: the
CPU tests hold the kernel's algorithm through them against the JAX package.
Nothing else calls them.
"""
from __future__ import annotations

import torch

from ..ops.remap import (
    _match_column_total, comp_sum, reference_dp, remap_levels_plain)
from ..profiling import launch_span, span
from . import _build

__all__ = ["SCHEMES", "remap_plan", "remap_packed_plain",
           "remap_packed_cuda", "remap_levels_cuda", "packed_air_mass",
           "fix_mass_plain", "remap_walk_emulated", "remap_packed_emulated"]

SCHEMES = ("pcm", "plm", "ppm")
# dynamic shared memory a block may take on the H100 (csrc/remap.cu)
MAX_SMEM = 232448
COLS = 32                      # columns (threads) a block of the kernel
# the geometry's segments, one a warp of the kernel (csrc/remap.cu kWarps);
# any number gives the same bits
SEGMENTS = 8
# csrc/remap.cu's fixer modes: the dp rows alone, the remap scaled by r
FIX_DP, FIX_SCALE = 1, 2


def remap_plan(nlev: int, itemsize: int, scheme: str) -> int:
    """Shared memory a block of the kernel takes (``remap_smem_bytes`` in
    csrc/remap.cu): the block's 2*nlev hybrid terms (to 16 bytes), and for
    each of its 32 columns dp_src, the field, the scheme's coefficients
    (plm 1, ppm 2 arrays) and the interfaces' fractions (nlev + 1) of
    itemsize bytes and the nlev + 1 cell indices; raises where it exceeds a
    block's."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown remap scheme {scheme!r}")
    ncoef = SCHEMES.index(scheme)
    per_col = ((3 + ncoef) * nlev + 1) * itemsize + (nlev + 1) * 2
    hybrid = -(-2 * nlev * itemsize // 16) * 16
    smem = -(-(hybrid + per_col * COLS) // 8) * 8
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


def packed_air_mass(s: torch.Tensor, sph_lanes: torch.Tensor, nlev: int):
    """spheremp-weighted air mass of the stacked state's dp rows, in the
    state's dtype and a fixed summation order: the mass fixer's functional
    (measure the target and the current mass with it, so its bias cancels in
    the ratio). ``sph_lanes`` is [1, E16]."""
    return (sph_lanes * s[3 * nlev:4 * nlev]).sum()


def fix_mass_plain(s_new, q_new, nlev: int, sph_lanes, mass_target):
    """The global dry-mass fixer in plain PyTorch, in place on a remap's
    outputs: the dp rows and every tracer times mass_target / the air mass
    of s_new. Returns (s_new, q_new)."""
    r = mass_target / packed_air_mass(s_new, sph_lanes, nlev)
    s_new[3 * nlev:] *= r
    q_new *= r
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
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {op} must be a tensor, got "
                            f"{type(t).__name__}")
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


def _count(wrapper, dtype, n: int = 1):
    wrapper.launches += n
    if dtype == torch.float64:
        wrapper.f64_launches += n


@launch_span
def remap_packed_cuda(s: torch.Tensor, qdp: torch.Tensor, hv, nlev: int,
                      qsize: int, scheme: str = "plm", sph_lanes=None,
                      mass_target=None):
    """The packed remap of s [4*nlev, C] and qdp [qsize*nlev, C] in one
    launch of the kernel; hv's hyai and hybi in s's dtype. With
    ``sph_lanes`` [1, C] and ``mass_target`` (a 0-d tensor; both in s's
    dtype, on s's device) the dry-mass fixer too, folded into the kernel's
    stores in two launches (the module's note); one without the other
    raises. Returns new (s', qdp')."""
    k, ncol = nlev, s.shape[-1]
    hv = hv.to(s.device)
    ops = {"s": (s, (4 * k, ncol)), "qdp": (qdp, (qsize * k, ncol)),
           "hyai": (hv.hyai, (k + 1,)), "hybi": (hv.hybi, (k + 1,))}
    fixer = sph_lanes is not None or mass_target is not None
    if fixer:
        if sph_lanes is None or mass_target is None:
            raise ValueError("remap_packed: the fixer needs both sph_lanes "
                             "and mass_target")
        ops.update(sph_lanes=(sph_lanes, (1, ncol)),
                   mass_target=(mass_target, ()))
    dev = _check("remap_packed", scheme, s.dtype, ops)
    if dev.type == "cpu":
        s_new, q_new = remap_packed_plain(s, qdp, hv, nlev, qsize, scheme)
        if fixer:
            fix_mass_plain(s_new, q_new, k, sph_lanes, mass_target)
        return s_new, q_new
    remap_plan(k, s.element_size(), scheme)
    s_out, q_out = torch.empty_like(s), torch.empty_like(qdp)
    lib = _build.library("remap")
    f64, sch = int(s.dtype == torch.float64), SCHEMES.index(scheme)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (s.data_ptr(), qdp.data_ptr(), hv.hyai.data_ptr(),
            hv.hybi.data_ptr(), float(hv.ps0), s_out.data_ptr(),
            q_out.data_ptr())
    if not fixer:
        err = lib.remap_packed_launch(f64, sch, *args, k, qsize, ncol, stream,
                                      dev.index)
        _build.check_launch("remap", err)
        _count(remap_packed_cuda, s.dtype)
        return s_out, q_out
    # (a) the dp rows; their air mass; (b) the remap scaled by the ratio
    err = lib.remap_fixer_launch(f64, sch, FIX_DP, *args, None, None, k,
                                 qsize, ncol, stream, dev.index)
    _build.check_launch("remap", err)
    with span("remap.fixer"):
        mass = packed_air_mass(s_out, sph_lanes, k)
    err = lib.remap_fixer_launch(f64, sch, FIX_SCALE, *args, mass.data_ptr(),
                                 mass_target.data_ptr(), k, qsize, ncol,
                                 stream, dev.index)
    _build.check_launch("remap", err)
    _count(remap_packed_cuda, s.dtype, 2)
    remap_packed_cuda.fixer_launches += 1
    return s_out, q_out


remap_packed_cuda.launches = 0
remap_packed_cuda.f64_launches = 0
remap_packed_cuda.fixer_launches = 0


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


def _coefficients(x, dp, scheme, tracer):
    """Each source cell's mass and reconstruction coefficients as the
    kernel's reconstruction computes them, [K, C] each: the mass (x * dp,
    or a tracer's x itself) and pcm nothing, plm c1 = m dp^2 / 2, ppm
    c1, c2 = dp aL, dp aR."""
    k = x.shape[0]
    q = x / dp if tracer else x
    mass = x if tracer else x * dp
    if scheme == "pcm":
        return mass, None, None
    if scheme == "plm":
        # one division an interface (the kernel's float division is the
        # card's fast one, within 2 ulps of this)
        d0, d1 = dp[:-1], dp[1:]
        if tracer:   # from the masses
            g = (x[1:] * d0 - x[:-1] * d1) / ((d0 * d1) * (0.5 * (d1 + d0)))
        else:
            g = (x[1:] - x[:-1]) / (0.5 * (d1 + d0))
        zero = torch.zeros_like(q[:1])
        g_lo, g_hi = torch.cat([zero, g]), torch.cat([g, zero])
        m = torch.where(g_lo * g_hi > 0.0,
                        torch.copysign(torch.minimum(g_lo.abs(), g_hi.abs()),
                                       g_lo), torch.zeros_like(q))
        return mass, (0.5 * (m * dp)) * dp, None
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
    return mass, dp * a_l, dp * a_r


def _lower(scheme, m, c1, c2, f):
    """L(c, f): the integral of a cell's reconstruction over the first
    fraction f of it, m its mass."""
    if scheme == "pcm":
        return m * f
    if scheme == "plm":
        return m * f + c1 * (f * (f - 1.0))
    g = 1.0 - f
    return m * (f * f * (3.0 - 2.0 * f)) + c1 * (f * g * g) \
        - c2 * (f * f * g)


def _passed_at(d):
    """The kernel's thresholds (csrc/remap.cu passed_at): the least x =
    t - s at which a cell of thickness d counts as passed, in float64."""
    f64 = torch.float64
    if d.dtype == f64:
        th = d.clone()
    else:
        bits = d.view(torch.int32)
        below = (bits - 1).view(torch.float32)
        mid = 0.5 * (below.to(f64) + d.to(f64))
        odd = (bits & 1) == 1
        th = torch.where(odd, torch.nextafter(mid, torch.full_like(
            mid, float("inf"))), mid)
    return torch.where(d > 0, th, torch.full_like(th, float("-inf")))


def _geometry(dp_src, dp_tgt):
    """The kernel's geometry pass on [K, C] columns: for every target
    interface t_j (running sums in float64 of dp_tgt, which may be float64)
    the first source cell c_j not passed (K past the end), a cell passed
    where t_j - s_c reaches its threshold (``_passed_at``), and the
    interface's fraction of that cell xi_j = a / dp_c, a = clip(t_j - s_c,
    0, dp_c) rounded to dp_src's dtype; t_K is the column's end. As the
    kernel's warps do, each of SEGMENTS segments of the interfaces 1 .. K-1
    sums its t and walks the cells from the column's top, first four cells
    a step while t lies past the fourth's end by a margin, then cell by
    cell. Returns (c [K+1, C] long, xi [K+1, C])."""
    k, ncol = dp_src.shape
    f64 = torch.float64
    c = torch.zeros(k + 1, ncol, dtype=torch.long, device=dp_src.device)
    xi = torch.zeros(k + 1, ncol, dtype=dp_src.dtype, device=dp_src.device)
    th_all = _passed_at(dp_src)
    n = k - 1
    for w in range(SEGMENTS):
        j_lo, j_hi = 1 + n * w // SEGMENTS, 1 + n * (w + 1) // SEGMENTS
        t = torch.zeros(ncol, dtype=f64, device=dp_src.device)
        for i in range(j_lo - 1):
            t = t + dp_tgt[i].to(f64)
        s = torch.zeros_like(t)
        cell = torch.zeros(ncol, dtype=torch.long, device=dp_src.device)
        take = lambda x: x.gather(0, cell.clamp(max=k - 1)[None])[0]
        for j in range(j_lo, j_hi):
            t = t + dp_tgt[j - 1].to(f64)
            if j == j_lo:
                # the segment's first walk: four cells a step while t lies
                # past the fourth one's end by the margin
                margin = t.abs() * 2.0 ** -40
                quad = cell + 4 <= k
                while bool(quad.any()):
                    ds = [dp_src.gather(0, (cell + i).clamp(max=k - 1)
                                        [None])[0] for i in range(4)]
                    s4 = s
                    for d in ds:
                        s4 = s4 + d.to(f64)
                    quad = quad & (t - s4 >= margin) & (
                        torch.stack(ds).min(0).values >= 0)
                    s = torch.where(quad, s4, s)
                    cell = torch.where(quad, cell + 4, cell)
                    quad = quad & (cell + 4 <= k)
            active = (cell < k) & (t - s >= take(th_all))
            while bool(active.any()):
                s = torch.where(active, s + take(dp_src).to(f64), s)
                cell = torch.where(active, cell + 1, cell)
                active = active & (cell < k) & (t - s >= take(th_all))
            d = take(dp_src)
            a = _clip(t - s, d.to(f64)).to(dp_src.dtype)
            c[j] = cell
            xi[j] = torch.where(cell < k, a / d, torch.zeros_like(a))
    c[k] = k
    return c, xi


def remap_walk_emulated(x: torch.Tensor, dp_src: torch.Tensor,
                        dp_tgt: torch.Tensor, scheme: str = "plm",
                        tracer: bool = False) -> torch.Tensor:
    """The kernel on [K, C] columns, vectorised over columns: the geometry
    pass, the reconstruction, then for every target cell j the lower
    integrals L at its interfaces and the masses of the cells between, in
    the kernel's order; the last target takes the rest of the column. x is
    a density (returns each target cell's mean: its mass times the
    reciprocal of dp_tgt rounded to x's dtype) or with ``tracer`` a
    tracer's mass qdp (returns the target cells' masses). dp_tgt may be
    float64 for float32 x (the packed kernel's layers)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown remap scheme {scheme!r}")
    k = x.shape[0]
    c, xi = _geometry(dp_src, dp_tgt)
    mass, c1, c2 = _coefficients(x, dp_src, scheme, tracer)
    take = lambda a, i: a.gather(0, i.clamp(max=k - 1)[None])[0]
    zero = torch.zeros_like(x[0])

    def lower(j):
        cell = c[j]
        at = lambda a: None if a is None else take(a, cell)
        val = _lower(scheme, at(mass), at(c1), at(c2), xi[j])
        return torch.where(cell < k, val, zero)

    rcp = 1.0 / dp_tgt.to(x.dtype)
    out = torch.empty_like(x)
    l_prev = lower(0)
    for j in range(k):
        c0, c1_ = c[j], c[j + 1]
        l_next = lower(j + 1)
        same = c1_ == c0
        acc = torch.where(same, l_next - l_prev, take(mass, c0) - l_prev)
        cell = c0 + 1
        mid = ~same & (cell < c1_)
        while bool(mid.any()):
            acc = torch.where(mid, acc + take(mass, cell), acc)
            cell = cell + 1
            mid = mid & (cell < c1_)
        acc = torch.where(~same & (c1_ < k), acc + l_next, acc)
        out[j] = acc if tracer else acc * rcp[j]
        l_prev = l_next
    return out


def remap_packed_emulated(s: torch.Tensor, qdp: torch.Tensor, hv, nlev: int,
                          qsize: int, scheme: str = "plm",
                          dp_only: bool = False, mass=None, target=None):
    """The packed kernel in torch: the dp rows by the kernel's operations in
    s's dtype (the compensated totals, ps, dp_ref from the hybrid terms, the
    ratio), the same chain in float64 from the same rounded terms for the
    layers the walk remaps onto, then the walk of u, v, T as densities and
    of every tracer's qdp as masses. Returns (s', qdp'). The fixer's two
    launches: with ``dp_only`` the first, which returns the dp rows [nlev,
    C] alone; with ``mass`` and ``target`` (0-d tensors) the second, whose
    dp rows and tracer values are each stored times r = target / mass (one
    rounded division, one rounded product a value; u, v, T unscaled)."""
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

    dp_tgt = layers(dp)
    if dp_only:
        return dp_tgt
    r = None if mass is None else target / mass
    store = (lambda x: x) if r is None else (lambda x: x * r)
    dp_walk = layers(dp.to(f64))
    walk = lambda x, tracer: remap_walk_emulated(x, dp, dp_walk, scheme,
                                                 tracer)
    s_new = torch.cat([walk(x, False) for x in s[:3 * k].split(k)]
                      + [store(dp_tgt)])
    q_new = torch.cat([store(walk(x, True)) for x in qdp.split(k)]) \
        if qsize else torch.empty_like(qdp)
    return s_new, q_new
