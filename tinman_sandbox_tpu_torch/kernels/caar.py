"""The CAAR step on the packed row layout [E16, nlev] (counterpart of
``tinman_sandbox_tpu/kernels/caar_pallas.py``).

The kernel is ``csrc/caar.cu``'s ``caar_row_kernel``: the level-chunked
body of the [nlev, E16] layout (``kernels/caar_t.py``) on tiles of 32
columns, each tile's fields staged through swizzled shared-memory planes:
a tile's columns are one contiguous span a field, copied in and written
back a 128-byte line a warp, and the passes run on the planes as the t
kernel runs on its stash (the source's note gives the design and its
shared-memory budget). Its plan is ``caar_t.caar_row_plan(ncol, nlev,
r0)``: ``caar_plan``'s chunks, staged up to 197 levels (161 at rsplit=0),
above that windowed (each warp copies 8 levels of its chunk at a time, 32
bytes a column, through slots of its own). At rsplit>0 its arithmetic is
the t kernel's line for
line, so it gives ``caar_t4_cuda``'s bits on the transposed problem. It
replaces ``caar_pallas_packed`` (caar_pallas.py:307, rsplit>0) and
``caar_pallas_packed_rsplit0`` (:365, rsplit=0: interface mass flux,
vertical advection of u, v and T, dp3d interface stencil, eta_dot_dpdn
accumulator), which run the same ``_caar_kernel`` body (:68-204); its
rsplit=0 dp tendency is formed as the (hybi(k+1) - hybi(k))*sdot that
divdp + eta_hi - eta_lo equals, without that sum's f32 cancellation.

  * ``caar_packed`` / ``caar_packed_plain``: the rsplit>0 step on unstacked
    [E16, nlev] buffers, meta [E16, 16]; the wrapper updates vn0u / vn0v /
    omg IN PLACE and counts its launches in ``caar_packed.launches``.
  * ``caar_packed_rsplit0`` / ``caar_packed_rsplit0_plain``: the rsplit=0
    step; ``hyb`` [2, nlev] holds hybi(k) in row 0 and hybi(k+1) in row 1,
    ``etaacc`` [E16, nlev] the eta_dot_dpdn accumulator at interfaces
    1..nlev, updated IN PLACE with the other three; launches in
    ``caar_packed_rsplit0.launches``.
  * ``pack_problem`` packs a full state into the row layout, with
    ``storage=`` the JAX package's mixed-precision contract (qdp and pecnd,
    with "bf16_ro" also the nm1 fields, in bf16; ``caar_t.STORAGE``), which
    both wrappers and the kernel take (its staging loads the bf16 spans
    two elements a 4-byte load and upcasts them into its f32 planes); a
    launch in a bf16 mode also counts in ``<wrapper>.storage_launches``;
    ``caar`` is the full-state wrapper (``caar_pallas``, ``storage=``
    included), dispatching on ``cfg.rsplit``;
    ``run_leapfrog`` the production leapfrog loop (``run_leapfrog_pallas``):
    pack once, rotate the packed buffers, unpack once; rsplit>0 only, as
    the JAX loop (``_require_lagrangian``).

The plain versions are the [nlev, E16] plain step (``caar_t``'s
``_physics_plain``) on transposed views, so the two layouts' plain versions
agree bit for bit. The wrappers run them for CPU tensors and launch the
kernel for CUDA tensors (float32, the storage operands float32 or bf16).

Options of the JAX module with no counterpart here: ``fused=``
(``_caar_kernel_fused``, :207: the derivative and scan matmuls batched for
the TPU's matrix unit, the same function); the block-derivative operators
and scan matrices of ``pack_problem`` (the kernel contracts the 4x4 Dvv);
``benchmark_loop_pallas`` (``bench --layout row`` chains the step itself).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..grid import Geometry, HybridVCoord
from ..state import Derived, State
from .caar_t import (_BF16, Packing, _caar_step, _on, _physics_plain,
                     _scalars, _storage_casts, full_step)
from .layout import pack_field, pack_meta, unpack_field

__all__ = ["caar_packed", "caar_packed_plain", "caar_packed_rsplit0",
           "caar_packed_rsplit0_plain", "pack_problem", "caar",
           "run_leapfrog"]


def _require_lagrangian(cfg: Config):
    """The packed leapfrog loop implements only the rsplit>0 vertically
    Lagrangian step; rsplit=0 runs through ``caar`` or ``caar_array``."""
    if cfg.rsplit <= 0:
        raise NotImplementedError(
            "this packed loop supports only rsplit > 0 (vertically "
            "Lagrangian); call caar/caar_array for the rsplit=0 path")


def _plain(scal, hyb, meta, fields, acc, etaacc, dvv, moist):
    """The row-layout step from the [nlev, E16] plain step on transposed
    views; pure."""
    u1, v1, t1, dp1, phi, vdp1, vdp2, omega_p, eta_hi = _physics_plain(
        scal, meta.T, dvv, *(x.T for x in fields), moist,
        None if hyb is None else hyb.T)
    eta = scal[0, 1]
    out = tuple(x.T.contiguous() for x in (u1, v1, t1, dp1, phi))
    out += tuple(a + eta * r.T for a, r in zip(acc, (vdp1, vdp2, omega_p)))
    return out if etaacc is None else (*out, etaacc + eta * eta_hi.T)


def caar_packed_plain(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp,
                      pecnd, vn0u, vn0v, omg, dvv, moist: bool = True):
    """Plain PyTorch ``caar_packed``. Pure: returns new (u1, v1, t1, dp1,
    phi, vn0u', vn0v', omg')."""
    return _plain(scal, None, meta, (u0, v0, t0, dp0, um1, vm1, tm1, dpm1,
                                     qdp, pecnd), (vn0u, vn0v, omg), None,
                  dvv, moist)


def caar_packed_rsplit0_plain(scal, hyb, meta, u0, v0, t0, dp0, um1, vm1,
                              tm1, dpm1, qdp, pecnd, vn0u, vn0v, omg, etaacc,
                              dvv, moist: bool = True):
    """Plain PyTorch ``caar_packed_rsplit0``. Pure: returns new (u1, v1, t1,
    dp1, phi, vn0u', vn0v', omg', etaacc')."""
    return _plain(scal, hyb, meta, (u0, v0, t0, dp0, um1, vm1, tm1, dpm1,
                                    qdp, pecnd), (vn0u, vn0v, omg), etaacc,
                  dvv, moist)


def caar_packed(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp, pecnd,
                vn0u, vn0v, omg, dvv, moist: bool = True):
    """The rsplit>0 CAAR step on [E16, nlev] buffers (counterpart of
    ``caar_pallas_packed``): scal [1, 4] = (dt2, eta_ave_w, hyai0*ps0, 0);
    meta [E16, 16]; dvv [4, 4]. Accumulators IN PLACE. Returns (u1, v1, t1,
    dp1, phi, vn0u, vn0v, omg)."""
    out = tuple(torch.empty_like(x) for x in (u0, v0, t0, dp0))
    phi = torch.empty_like(u0)
    if _caar_step(scal, meta, dvv, (u0, v0, t0, dp0), (um1, vm1, tm1, dpm1),
                  qdp, pecnd, (vn0u, vn0v, omg), out, phi, moist, row=True):
        caar_packed.launches += 1
        caar_packed.storage_launches += qdp.dtype == _BF16
    return (*out, phi, vn0u, vn0v, omg)


caar_packed.launches = 0
caar_packed.storage_launches = 0


def caar_packed_rsplit0(scal, hyb, meta, u0, v0, t0, dp0, um1, vm1, tm1,
                        dpm1, qdp, pecnd, vn0u, vn0v, omg, etaacc, dvv,
                        moist: bool = True):
    """The rsplit=0 (full eta-coordinate) step on [E16, nlev] buffers
    (counterpart of ``caar_pallas_packed_rsplit0``): ``hyb`` [2, nlev],
    ``etaacc`` [E16, nlev] at interfaces 1..nlev. The four accumulators are
    updated IN PLACE. Returns (u1, v1, t1, dp1, phi, vn0u, vn0v, omg,
    etaacc)."""
    out = tuple(torch.empty_like(x) for x in (u0, v0, t0, dp0))
    phi = torch.empty_like(u0)
    if _caar_step(scal, meta, dvv, (u0, v0, t0, dp0), (um1, vm1, tm1, dpm1),
                  qdp, pecnd, (vn0u, vn0v, omg), out, phi, moist, hyb=hyb,
                  etaacc=etaacc, row=True):
        caar_packed_rsplit0.launches += 1
        caar_packed_rsplit0.storage_launches += qdp.dtype == _BF16
    return (*out, phi, vn0u, vn0v, omg, etaacc)


caar_packed_rsplit0.launches = 0
caar_packed_rsplit0.storage_launches = 0


def pack_problem(state: State, derived: Derived, geom: Geometry,
                 hv: HybridVCoord, cfg: Config, dtype=torch.float32,
                 storage: str = "f32"):
    """Pack into the row layout on the state's device: dvv, meta [E16, 16]
    and the 13 fields [E16, nlev] of ``pack_problem_t``'s contract, its
    ``storage`` included (caar_pallas.py:415)."""
    f, aux, ro = _storage_casts(dtype, storage, "pack_problem")
    n0, nm1, qn0 = cfg.n0, cfg.nm1, cfg.qn0
    p = lambda cast, x: pack_field(cast(x))
    return dict(
        dvv=geom.dvv.to(dtype).contiguous(),
        meta=pack_meta(geom, state.phis, dtype),
        u0=p(f, state.u[n0]), v0=p(f, state.v[n0]),
        t0=p(f, state.t[n0]), dp0=p(f, state.dp3d[n0]),
        um1=p(ro, state.u[nm1]), vm1=p(ro, state.v[nm1]),
        tm1=p(ro, state.t[nm1]), dpm1=p(ro, state.dp3d[nm1]),
        qdp=p(aux, state.qdp[qn0, :, 0]),
        pecnd=p(aux, derived.pecnd),
        vn0u=p(f, derived.vn0_u), vn0v=p(f, derived.vn0_v),
        omg=p(f, derived.omega_p),
    )


def _hyb_row(hybi, nlev):
    return torch.stack([hybi[:nlev], hybi[1:nlev + 1]]).contiguous()


ROW_PACKING = Packing(problem=pack_problem, field=pack_field,
                      unfield=unpack_field, hyb=_hyb_row)


def caar(state: State, derived: Derived, geom: Geometry, hv: HybridVCoord,
         cfg: Config, dt2, eta_ave_w, moist: bool = True, device="cuda",
         storage: str = "f32"):
    """Full-state wrapper with the contract of ``caar_array`` on the row
    layout (counterpart of ``caar_pallas``): pack (in ``storage``'s
    contract), one kernel step, unpack.
    ``cfg.rsplit`` = 0 runs ``caar_packed_rsplit0`` and advances
    eta_dot_dpdn at interfaces 1..nlev (interface 0 keeps the old value);
    rsplit>0 ``caar_packed``. Returns (new_state, new_derived) on
    ``device``."""
    step = caar_packed if cfg.rsplit > 0 else caar_packed_rsplit0
    return full_step(step, ROW_PACKING, state, derived, geom, hv, cfg, dt2,
                     eta_ave_w, moist, device, storage)


_LF_NAMES = ("u", "v", "t", "dp3d")


def run_leapfrog(state: State, derived: Derived, geom: Geometry,
                 hv: HybridVCoord, cfg: Config, nsteps: int,
                 moist: bool = True, device="cuda"):
    """Production leapfrog loop on the row layout (counterpart of
    ``run_leapfrog_pallas``): pack once, one ``caar_packed`` step per time
    step with time-level rotation of the packed (u, v, T, dp) buffers,
    unpack once. dt2 = 2*dt and eta_ave_w = 1/nsteps. Returns (state,
    derived, cfg) with cfg carrying the rotated time levels."""
    from ..timeloop.driver import rotated

    _require_lagrangian(cfg)
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = pack_problem(state, derived, geom, hv, cfg, dtype)
    scal = _scalars(2.0 * cfg.dt, 1.0 / max(nsteps, 1), hv, dtype, dev)
    bufs = [[pack_field(getattr(state, n)[tl].to(dtype)) for n in _LF_NAMES]
            for tl in range(3)]
    acc = (p["vn0u"], p["vn0v"], p["omg"])
    phi = None
    c = cfg
    for _ in range(nsteps):
        *s1, phi, vn0u, vn0v, omg = caar_packed(
            scal, p["meta"], *bufs[c.n0], *bufs[c.nm1], p["qdp"], p["pecnd"],
            *acc, p["dvv"], moist=moist)
        acc = (vn0u, vn0v, omg)
        bufs[c.np1] = s1
        c = rotated(c)

    un = lambda x: unpack_field(x, cfg.nelem)
    new_state = dataclasses.replace(state, **{
        n: torch.stack([un(bufs[tl][i]) for tl in range(3)])
        for i, n in enumerate(_LF_NAMES)})
    new_derived = dataclasses.replace(
        derived, vn0_u=un(acc[0]), vn0_v=un(acc[1]), omega_p=un(acc[2]),
        phi=derived.phi.clone() if phi is None else un(phi))
    return new_state, new_derived, c
