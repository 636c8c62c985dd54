"""The CAAR step on the packed [nlev, E16] layout (counterpart of
``tinman_sandbox_tpu/kernels/caar_pallas_t.py``, rsplit>0, f32 storage).

The kernel is ``csrc/caar.cu``. It replaces the Pallas kernels
``caar_pallas_packed_t4_lg`` (caar_pallas_t.py:542, the bench headline),
``caar_pallas_packed_t`` (:349) and ``caar_pallas_packed_t4`` (:405), which
all run ``_caar_physics`` (:59-133) plus the accumulator update (:525-527).
It is bound by device-memory traffic; the source's note gives its design.
Where the TPU kernel took 128x128 block-diagonal derivative operators and
triangular scan matrices to feed its matrix unit, this one takes the 4x4
``dvv`` and runs the scans as running sums.

  * ``caar_t4_plain`` is the same function in plain PyTorch (cumsum and an
    einsum over ``dvv``). The CPU tests use it; on a card only the checks of
    the kernel against it call it.
  * ``caar_t4_cuda`` is the stacked-state entry (rows 1 and 3 of the kernel
    table) and ``caar_packed_t`` the unstacked one (row 2). Both check their
    operands, run the plain version for CPU tensors and launch the kernel
    for CUDA tensors, counted in ``caar_t4_cuda.launches``. Both write the
    vn0u/vn0v/omg accumulators IN PLACE.
  * ``caar_t`` is the full-state wrapper (``caar_pallas_t``) and
    ``run_leapfrog_t`` the production leapfrog loop
    (``run_leapfrog_pallas_t``): pack once, rotate packed buffers, unpack
    once.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import NPSQ, Config
from ..constants import CONSTANTS
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord
from ..ops.sphere import full_precision_matmuls
from ..state import Derived, State
from . import _build
from .layout import META_COLS, pack_field_t, pack_meta_t, unpack_field_t

__all__ = [
    "caar_t4_plain",
    "caar_t4_cuda",
    "caar_packed_t",
    "pack_problem_t",
    "caar_t",
    "run_leapfrog_t",
]

_MC = {name: i for i, name in enumerate(META_COLS)}
# the largest nlev whose per-column scan buffer fits one block's shared memory
_MAX_NLEV = 400


def _physics_plain(scal, meta, dvv, u, v, t, dp, um1, vm1, tm1, dpm1,
                   qdp, pecnd, moist):
    """``_caar_physics`` on [k, E16] tensors: returns
    (u1, v1, t1, dp1, phi, vdp1, vdp2, omega_p)."""
    full_precision_matmuls()
    c = CONSTANTS
    k, e16 = u.shape
    ne = e16 // NPSQ
    dt2, h = scal[0, 0], scal[0, 2]
    rr = c.rrearth

    def row(name):
        return meta[_MC[name]]                       # [E16], broadcast on k

    def dx(s):
        return torch.einsum("il,keij->kelj", dvv,
                            s.reshape(k, ne, 4, 4)).reshape(k, e16)

    def dy(s):
        return torch.einsum("keji,il->kejl", s.reshape(k, ne, 4, 4),
                            dvv).reshape(k, e16)

    dinv00, dinv01 = row("dinv00"), row("dinv01")
    dinv10, dinv11 = row("dinv10"), row("dinv11")
    metdet, rmetdet = row("metdet"), row("rmetdet")

    def grad(s):
        v1, v2 = dx(s) * rr, dy(s) * rr
        return dinv00 * v1 + dinv10 * v2, dinv01 * v1 + dinv11 * v2

    def div(a, b):
        gv1 = metdet * (dinv00 * a + dinv01 * b)
        gv2 = metdet * (dinv10 * a + dinv11 * b)
        return (dx(gv1) + dy(gv2)) * (rmetdet * rr)

    zero = torch.zeros_like(dp[:1])
    p = h + torch.cumsum(dp, 0) - 0.5 * dp
    gp1, gp2 = grad(p)
    vgrad_p = u * gp1 + v * gp2
    vdp1, vdp2 = u * dp, v * dp
    divdp = div(vdp1, vdp2)
    vco1 = row("d00") * u + row("d10") * v
    vco2 = row("d01") * u + row("d11") * v
    vort = (dx(vco2) - dy(vco1)) * (rmetdet * rr)
    t_v = t * (1.0 + c.rgas_over_rvap_m1 * (qdp / dp)) if moist else t
    q = c.Rgas * t_v * (dp / p)
    rev_strict = torch.cat([torch.flip(torch.cumsum(torch.flip(q, (0,)), 0),
                                       (0,))[1:], zero])
    phi = row("phis") + rev_strict + 0.5 * q
    cum_strict = torch.cat([zero, torch.cumsum(divdp, 0)[:-1]])
    omega_p = (vgrad_p - cum_strict - 0.5 * divdp) / p
    ephi = 0.5 * (u * u + v * v) + phi + pecnd
    gt1, gt2 = grad(t)
    ge1, ge2 = grad(ephi)
    gpterm = c.Rgas * (t_v / p)
    fcor_vort = row("fcor") + vort
    vtens1 = v * fcor_vort - ge1 - gpterm * gp1
    vtens2 = -(u * fcor_vort) - ge2 - gpterm * gp2
    ttens = -(u * gt1 + v * gt2) + c.kappa * t_v * omega_p
    sph = row("spheremp")
    return (sph * (um1 + dt2 * vtens1), sph * (vm1 + dt2 * vtens2),
            sph * (tm1 + dt2 * ttens), sph * (dpm1 - dt2 * divdp),
            phi, vdp1, vdp2, omega_p)


def caar_t4_plain(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                  moist: bool = True):
    """Plain PyTorch CAAR step on stacked [4*nlev, E16] states. Pure:
    returns new (s1, phi, vn0u', vn0v', omg') and modifies nothing."""
    k = qdp.shape[0]
    u1, v1, t1, dp1, phi, vdp1, vdp2, omega_p = _physics_plain(
        scal, meta, dvv, *s0.split(k), *sm1.split(k), qdp, pecnd, moist)
    eta = scal[0, 1]
    return (torch.cat([u1, v1, t1, dp1]), phi, vn0u + eta * vdp1,
            vn0v + eta * vdp2, omg + eta * omega_p)


def _check(scal, meta, dvv, fields, nlev):
    """Validate the operands of one CAAR step; returns the device."""
    ref = fields[0]
    dev, dtype = ref.device, ref.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"caar: needs float fields, got {dtype}")
    if dev.type == "cuda" and dtype != torch.float32:
        raise TypeError("caar: the CUDA kernel takes float32 only")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"caar: unsupported device {dev}")
    e16 = ref.shape[-1]
    if e16 % NPSQ:
        raise ValueError(f"caar: E16={e16} is not a multiple of {NPSQ}")
    want = {"meta": (meta, (len(META_COLS), e16)), "dvv": (dvv, (4, 4)),
            "scal": (scal, (1, 4))}
    want.update({f"field{i}": (f, (nlev, e16)) for i, f in enumerate(fields)})
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"caar: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"caar: {name} is {x.dtype} on {x.device}, "
                             f"expected {dtype} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"caar: {name} must be contiguous")
    if dev.type == "cuda" and nlev > _MAX_NLEV:
        raise ValueError(f"caar: nlev={nlev} exceeds the kernel's "
                         f"{_MAX_NLEV}-level shared-memory buffer")
    return dev


def _caar_step(scal, meta, dvv, s0, sm1, qdp, pecnd, acc, out, phi, moist):
    """One step on [nlev, E16] views: s0/sm1/out are 4-tuples (u, v, t, dp),
    acc the 3 accumulators (updated in place), phi the output buffer."""
    nlev = qdp.shape[0]
    dev = _check(scal, meta, dvv,
                 (*s0, *sm1, qdp, pecnd, *acc, *out, phi), nlev)
    if dev.type == "cpu":
        u1, v1, t1, dp1, ph, vdp1, vdp2, omega_p = _physics_plain(
            scal, meta, dvv, *s0, *sm1, qdp, pecnd, moist)
        for o, r in zip((*out, phi), (u1, v1, t1, dp1, ph)):
            o.copy_(r)
        eta = scal[0, 1]
        for a, r in zip(acc, (vdp1, vdp2, omega_p)):
            a.add_(eta * r)
        return
    ptr = lambda x: x.data_ptr()
    c = CONSTANTS
    err = _build.library("caar").caar_launch(
        ptr(scal), ptr(meta), ptr(dvv), *map(ptr, s0), *map(ptr, sm1),
        ptr(qdp), ptr(pecnd), *map(ptr, acc), *map(ptr, out), ptr(phi),
        nlev, qdp.shape[1], qdp.stride(0), int(bool(moist)),
        c.Rgas, c.kappa, c.rgas_over_rvap_m1, c.rrearth,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check_launch("caar", err)
    caar_t4_cuda.launches += 1


def caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                 moist: bool = True):
    """Stacked-state CAAR step (counterpart of ``caar_pallas_packed_t4_lg``
    and ``caar_pallas_packed_t4``). scal [1,4] = (dt2, eta_ave_w, hyai0*ps0,
    0); meta [16, E16]; s0, sm1 [4*nlev, E16] (u/v/t/dp row blocks); qdp,
    pecnd, vn0u, vn0v, omg [nlev, E16]; dvv [4, 4]. The accumulators are
    updated IN PLACE. Returns (s1, phi, vn0u, vn0v, omg)."""
    k = qdp.shape[0]
    if s0.shape[0] != 4 * k or sm1.shape[0] != 4 * k:
        raise ValueError(f"caar: s0/sm1 need {4 * k} rows, got "
                         f"{s0.shape[0]}/{sm1.shape[0]}")
    s1 = torch.empty_like(s0)
    phi = torch.empty_like(qdp)
    _caar_step(scal, meta, dvv, s0.split(k), sm1.split(k), qdp, pecnd,
               (vn0u, vn0v, omg), s1.split(k), phi, moist)
    return s1, phi, vn0u, vn0v, omg


caar_t4_cuda.launches = 0


def caar_packed_t(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1,
                  qdp, pecnd, vn0u, vn0v, omg, dvv, moist: bool = True):
    """Unstacked CAAR step (counterpart of ``caar_pallas_packed_t``): one
    [nlev, E16] buffer per field, the same kernel. Accumulators in place.
    Returns (u1, v1, t1, dp1, phi, vn0u, vn0v, omg)."""
    out = tuple(torch.empty_like(x) for x in (u0, v0, t0, dp0))
    phi = torch.empty_like(qdp)
    _caar_step(scal, meta, dvv, (u0, v0, t0, dp0), (um1, vm1, tm1, dpm1),
               qdp, pecnd, (vn0u, vn0v, omg), out, phi, moist)
    return (*out, phi, vn0u, vn0v, omg)


def pack_problem_t(state: State, derived: Derived, geom: Geometry,
                   hv: HybridVCoord, cfg: Config, dtype=torch.float32):
    """Pack into the kernel layout on the state's device (the f32 storage
    contract of the JAX package; on the CPU any float dtype)."""
    f = lambda x: pack_field_t(x.to(dtype))
    n0, nm1, qn0 = cfg.n0, cfg.nm1, cfg.qn0
    return dict(
        dvv=geom.dvv.to(dtype).contiguous(),
        meta=pack_meta_t(geom, state.phis, dtype),
        u0=f(state.u[n0]), v0=f(state.v[n0]),
        t0=f(state.t[n0]), dp0=f(state.dp3d[n0]),
        um1=f(state.u[nm1]), vm1=f(state.v[nm1]),
        tm1=f(state.t[nm1]), dpm1=f(state.dp3d[nm1]),
        qdp=f(state.qdp[qn0, :, 0]),
        pecnd=f(derived.pecnd),
        vn0u=f(derived.vn0_u), vn0v=f(derived.vn0_v), omg=f(derived.omega_p),
    )


def _scalars(dt2, eta_ave_w, hv: HybridVCoord, dtype, device):
    """The kernel's [1, 4] scalar operand: (dt2, eta_ave_w, hyai0*ps0, 0)."""
    return torch.tensor(
        [[float(dt2), float(eta_ave_w), float(hv.hyai[0]) * hv.ps0, 0.0]],
        dtype=dtype, device=device)


def _on(device, *objs):
    dev = resolve_device(device)
    return dev, [o.to(dev) for o in objs]


def caar_t(state: State, derived: Derived, geom: Geometry, hv: HybridVCoord,
           cfg: Config, dt2, eta_ave_w, moist: bool = True, device="cuda"):
    """Full-state wrapper with the contract of ``caar_array`` on the packed
    layout (counterpart of ``caar_pallas_t``): pack, one kernel step, unpack.
    Returns (new_state, new_derived) on ``device``."""
    if cfg.rsplit <= 0:
        raise NotImplementedError("caar_t ports the rsplit>0 path only; "
                                  "rsplit=0 is not yet ported")
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = pack_problem_t(state, derived, geom, hv, cfg, dtype)
    scal = _scalars(dt2, eta_ave_w, hv, dtype, dev)
    u1, v1, t1, dp1, phi, vn0u, vn0v, omg = caar_packed_t(
        scal, p["meta"], p["u0"], p["v0"], p["t0"], p["dp0"],
        p["um1"], p["vm1"], p["tm1"], p["dpm1"],
        p["qdp"], p["pecnd"], p["vn0u"], p["vn0v"], p["omg"], p["dvv"],
        moist=moist)
    ne, np1 = cfg.nelem, cfg.np1

    def put(x, packed):
        out = x.clone()
        out[np1] = unpack_field_t(packed, ne)
        return out

    new_state = dataclasses.replace(
        state, u=put(state.u, u1), v=put(state.v, v1), t=put(state.t, t1),
        dp3d=put(state.dp3d, dp1))
    new_derived = dataclasses.replace(
        derived, vn0_u=unpack_field_t(vn0u, ne),
        vn0_v=unpack_field_t(vn0v, ne), phi=unpack_field_t(phi, ne),
        omega_p=unpack_field_t(omg, ne))
    return new_state, new_derived


_LF_NAMES = ("u", "v", "t", "dp3d")


def run_leapfrog_t(state: State, derived: Derived, geom: Geometry,
                   hv: HybridVCoord, cfg: Config, nsteps: int,
                   moist: bool = True, device="cuda"):
    """Production leapfrog loop on the packed layout (counterpart of
    ``run_leapfrog_pallas_t``): pack once, one ``caar_t4_cuda`` step per time
    step with time-level rotation, unpack once. dt2 = 2*dt and
    eta_ave_w = 1/nsteps. Returns (state, derived, cfg) with cfg carrying
    the rotated time levels."""
    return _leapfrog_loop(caar_t4_cuda, state, derived, geom, hv, cfg,
                          nsteps, moist, device)


def _leapfrog_loop(step, state, derived, geom, hv, cfg, nsteps, moist,
                   device):
    """The loop of ``run_leapfrog_t`` with the step function as a parameter,
    so a check on the card can run the same loop on ``caar_t4_plain``."""
    from ..timeloop.driver import rotated

    if cfg.rsplit <= 0:
        raise NotImplementedError(
            "the packed leapfrog loop supports only rsplit > 0")
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = pack_problem_t(state, derived, geom, hv, cfg, dtype)
    scal = _scalars(2.0 * cfg.dt, 1.0 / max(nsteps, 1), hv, dtype, dev)
    bufs = [torch.cat([pack_field_t(getattr(state, n)[tl].to(dtype))
                       for n in _LF_NAMES]) for tl in range(3)]
    acc = (p["vn0u"], p["vn0v"], p["omg"])
    phi = None
    c = cfg
    for _ in range(nsteps):
        s1, phi, *acc = step(scal, p["meta"], bufs[c.n0], bufs[c.nm1],
                             p["qdp"], p["pecnd"], *acc, p["dvv"],
                             moist=moist)
        bufs[c.np1] = s1
        c = rotated(c)

    ne, k = cfg.nelem, cfg.nlev
    un = lambda x: unpack_field_t(x, ne)
    new_state = dataclasses.replace(state, **{
        n: torch.stack([un(bufs[tl][i * k:(i + 1) * k]) for tl in range(3)])
        for i, n in enumerate(_LF_NAMES)})
    new_derived = dataclasses.replace(
        derived, vn0_u=un(acc[0]), vn0_v=un(acc[1]), omega_p=un(acc[2]),
        phi=derived.phi.clone() if phi is None else un(phi))
    return new_state, new_derived, c
