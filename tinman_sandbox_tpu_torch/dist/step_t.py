"""The assembled steps on the packed transposed layout: the CAAR kernel,
the weak-Laplacian kernel and the structured DSS kernels (counterpart of
the assembled-step, SSPRK3 and hyperviscosity parts of
``tinman_sandbox_tpu/dist/step_pallas.py``).

  * ``caar_dss_structured_packed_t4``: stacked state, one [4*nlev, E16]
    buffer per time level. The CAAR kernel also writes the fix-lane slab,
    so the DSS runs as fixup + sweep with no separate extraction. The JAX
    function's lane grouping (``lg``), elem_block / 128-lane admissibility
    and dense-or-compact slab choice are TPU workarounds with no
    counterpart: one path serves every ne, odd ne included.
  * ``caar_dss_structured_packed_t4_plain``: the same function from the
    plain versions alone (``caar_t4_plain``, ``dss_fixup_plain``,
    ``dss_sweep_plain``), which a check on the card holds the kernels
    against.
  * ``caar_dss_structured_packed_t``: unstacked buffers, then extraction,
    fixup and sweep for each field.
  * ``caar_dss_t``: the full-state wrapper (pack, unstacked step, unpack;
    counterpart of ``caar_dss_pallas(dss="structured_t")``).
  * ``caar_dss_structured_packed``: the assembled step on the ROW layout
    [E16, nlev] (counterpart of ``caar_dss_structured_packed`` of the JAX
    package): the row CAAR kernel (``kernels.caar.caar_packed``), then one
    structured DSS over the four fields stacked [E16, 4*nlev], scaled by
    ``rsp_rows`` [E16, 1]; that DSS is plain PyTorch, as the JAX package
    computes it in XLA array code. ``caar_dss`` is its full-state wrapper
    (``caar_dss_pallas(dss="structured")``). The JAX function's ``chunks``
    and ``stack_dss=False`` are TPU pipeline workarounds with no
    counterpart.
  * ``ssprk3_packed_t4``: SSPRK3 dynamics, three stages of (CAAR kernel in
    its single-state stage mode with the slab, fixup, sweep), the Shu-Osher
    combinations folded into the sweep's affine output; needs a CONTINUOUS
    s0. ``ssprk3_packed_t4_plain`` is its twin from the plain versions and
    ``ssprk3_t`` the full-state wrapper.
  * ``apply_hypervis_packed_t``: biharmonic hyperviscosity, per subcycle two
    (weak-Laplacian kernel with the slab, fixup, sweep) passes, the update
    x - step*grad^4(x) being the second sweep's affine output. On the full
    [4*nlev, E16] buffer it updates the (u, v, T) rows IN PLACE and the dp
    rows ride through. ``apply_hypervis_packed_t_plain`` is its twin (pure)
    and ``apply_hypervis_t`` the full-state wrapper.

  * ``ssprk3_tracer_packed_t``: SSPRK3 tracer transport on the stacked
    [qsize*nlev, E16] tracers. Without the limiter each stage is (Euler
    kernel with the slab, fixup, sweep), the Shu-Osher combinations folded
    into the sweep's affine output; needs a CONTINUOUS qdp. With the limiter
    each stage is (fused limit kernel with the slab, fixup, sweep): the
    combination sits inside the kernel, ahead of the nonlinear limiter, and
    the sweep carries none. ``ssprk3_tracer_packed_t_plain`` is its twin.
    The JAX function's ``eb``, ``lg``, ``qc``, ``fuse_extract``,
    ``compact`` and ``limit_strategy`` options and its unfused field-limiter
    fallback choose between TPU VMEM budgets and 128-lane layouts and have
    no counterpart: one path serves every ne, odd ne included.
  * ``prim_step_packed_t4``: the full model step (SSPRK3 dynamics,
    hyperviscosity in place on the new state, ``qsplit`` tracer substeps
    that read the new winds out of that state by row block), everything in
    the packed layout. ``prim_step_packed_t4_plain`` is its twin and
    ``prim_t`` the full-state wrapper, from ``prim_pack_t`` and
    ``prim_unpack_t``, which a caller that chains steps calls once each.
  * ``remap_packed_t4``: the conservative vertical remap of the stacked
    state and tracers back to the reference hybrid levels, with the global
    dry-mass fixer (``packed_air_mass``), run every rsplit-th step of the
    packed cadence. Array code in the JAX package (no Pallas kernel); here
    one launch of the remap kernel (``kernels/remap.py``) on the packed
    rows for CUDA tensors, and ``remap_packed_t4_plain``, plain PyTorch
    with levels on axis 0 in place of JAX's unpack / repack (the same
    columns, the same arithmetic), for CPU tensors.

  * The ring-fused path (counterpart of ``caar_dss_ring_t4``,
    ``ssprk3_ring_t4`` and ``ssprk3_tracer_ring_t`` of the JAX package):
    each stage is ONE ring launch (``kernels/ring_fused.py``: the CAAR or
    Euler update and its merge-free sweep, the Shu-Osher combination in the
    emission) closed by the fixup and the in-place patch of the fix lanes,
    in place of the producer, the fixup and the sweep. Each is bit for bit
    the two-launch step it replaces; each has a ``_plain`` twin. The JAX
    ring's even-ne and 128-lane limits have no counterpart: odd ne serves.
    ``_ring_tables`` maps to ``fix_tables``: no new table.

The accumulators vn0u / vn0v / omg are updated IN PLACE, as by the CAAR
kernel (the plain twins are pure and return new ones).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..grid import Geometry, HybridVCoord
from ..kernels.caar import caar_packed, pack_problem
from ..kernels.caar_t import (
    _on, _scalars, caar_packed_t, caar_t4_cuda, caar_t4_plain, pack_problem_t)
from ..kernels.dss import (
    dss_fixup_cuda, dss_fixup_plain, dss_merge_patch_cuda,
    dss_merge_patch_plain, dss_structured_t_cuda, dss_structured_t_cuda_pre,
    dss_sweep_plain, fix_tables)
from ..kernels.hypervis_t import vlap_cuda, vlap_plain
from ..kernels.layout import (
    pack_field_t, pack_meta_t, unpack_field, unpack_field_t)
from ..kernels.remap import remap_packed_cuda, remap_packed_plain
from ..kernels.ring_fused import (
    caar_ring_packed_t4, caar_ring_plain, tracer_ring_packed_t,
    tracer_ring_plain)
from ..kernels.tracer_t import (
    tracer_euler_cuda, tracer_euler_plain, tracer_limit_cuda,
    tracer_limit_plain)
from ..state import Derived, State
from ..timeloop.driver import rotated
from ..timeloop.rk import B_WEIGHTS, third_stage_weights
from .structured_dss import StructuredDssPlan, dss_structured_scaled

__all__ = ["caar_dss_structured_packed_t4",
           "caar_dss_structured_packed_t4_plain",
           "caar_dss_structured_packed_t", "caar_dss_t",
           "caar_dss_structured_packed", "caar_dss",
           "ssprk3_packed_t4", "ssprk3_packed_t4_plain", "ssprk3_t",
           "apply_hypervis_packed_t", "apply_hypervis_packed_t_plain",
           "apply_hypervis_t",
           "ssprk3_tracer_packed_t", "ssprk3_tracer_packed_t_plain",
           "prim_step_packed_t4", "prim_step_packed_t4_plain",
           "prim_pack_t", "prim_unpack_t", "prim_t",
           "remap_packed_t4", "remap_packed_t4_plain", "packed_air_mass",
           "caar_dss_ring_t4", "caar_dss_ring_t4_plain", "ssprk3_ring_t4",
           "ssprk3_ring_t4_plain", "ssprk3_tracer_ring_t",
           "ssprk3_tracer_ring_t_plain"]

def caar_dss_structured_packed_t4(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                                  omg, dvv, plan: StructuredDssPlan,
                                  rsp: torch.Tensor, moist: bool = True):
    """One assembled step on stacked [4*nlev, E16] states: the CAAR kernel
    with its slab output, then fixup and sweep over the stacked s1. rsp is
    [1, E16] or the two-float [2, E16]. Returns (s1_assembled, phi, vn0u,
    vn0v, omg)."""
    fix = fix_tables(plan, s0.device)
    s1, phi, vn0u, vn0v, omg, slab = caar_t4_cuda(
        scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv, moist=moist,
        fix=fix)
    return (dss_structured_t_cuda_pre(s1, slab, plan, rsp), phi, vn0u, vn0v,
            omg)


def caar_dss_structured_packed_t4_plain(scal, meta, s0, sm1, qdp, pecnd,
                                        vn0u, vn0v, omg, dvv,
                                        plan: StructuredDssPlan,
                                        rsp: torch.Tensor, moist: bool = True):
    """``caar_dss_structured_packed_t4`` from the plain versions on any
    device; pure. Returns (s1_assembled, phi, vn0u', vn0v', omg')."""
    fix = fix_tables(plan, s0.device)
    s1, phi, vn0u, vn0v, omg, slab = caar_t4_plain(
        scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv, moist=moist,
        fix=fix)
    vd = dss_fixup_plain(slab, fix, rsp)
    return dss_sweep_plain(s1, rsp, vd, fix), phi, vn0u, vn0v, omg


def caar_dss_structured_packed_t(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1,
                                 dpm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                                 plan: StructuredDssPlan, rsp: torch.Tensor,
                                 moist: bool = True):
    """One assembled step on unstacked [nlev, E16] buffers: the CAAR kernel,
    then a whole DSS (extract, fixup, sweep) for each of u, v, T, dp.
    Returns (u1, v1, t1, dp1, phi, vn0u, vn0v, omg), the first four
    assembled."""
    o = caar_packed_t(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp,
                      pecnd, vn0u, vn0v, omg, dvv, moist=moist)
    return tuple(dss_structured_t_cuda(x, plan, rsp) for x in o[:4]) + o[4:]


def caar_dss_t(state: State, derived: Derived, geom: Geometry,
               hv: HybridVCoord, plan: StructuredDssPlan, cfg: Config, dt2,
               eta_ave_w, moist: bool = True, device="cuda"):
    """Full-state assembled step with the contract of ``dist.step.
    caar_dss_step`` on the packed layout: pack, one unstacked assembled
    step, unpack. rspheremp is the geometry's, as one f32 (or the state's
    dtype on the CPU) row. Returns (new_state, new_derived) on ``device``."""
    if cfg.rsplit <= 0:
        raise NotImplementedError("caar_dss_t ports the rsplit>0 path only")
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = pack_problem_t(state, derived, geom, hv, cfg, dtype)
    scal = _scalars(dt2, eta_ave_w, hv, dtype, dev)
    rsp = _rsp_row(geom, dtype)
    u1, v1, t1, dp1, phi, vn0u, vn0v, omg = caar_dss_structured_packed_t(
        scal, p["meta"], p["u0"], p["v0"], p["t0"], p["dp0"],
        p["um1"], p["vm1"], p["tm1"], p["dpm1"], p["qdp"], p["pecnd"],
        p["vn0u"], p["vn0v"], p["omg"], p["dvv"], plan, rsp, moist=moist)
    nelem, np1 = cfg.nelem, cfg.np1

    def put(x, packed):
        out = x.clone()
        out[np1] = unpack_field_t(packed, nelem)
        return out

    new_state = dataclasses.replace(
        state, u=put(state.u, u1), v=put(state.v, v1), t=put(state.t, t1),
        dp3d=put(state.dp3d, dp1))
    new_derived = dataclasses.replace(
        derived, vn0_u=unpack_field_t(vn0u, nelem),
        vn0_v=unpack_field_t(vn0v, nelem), phi=unpack_field_t(phi, nelem),
        omega_p=unpack_field_t(omg, nelem))
    return new_state, new_derived


def caar_dss_structured_packed(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1,
                               dpm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                               plan: StructuredDssPlan, rsp_rows: torch.Tensor,
                               moist: bool = True):
    """One assembled step on the row layout: the row CAAR kernel on
    [E16, nlev] buffers (meta [E16, 16]), then rsp_rows * DSS over the four
    new fields stacked [E16, 4*nlev]; rsp_rows is [E16, 1]. Accumulators IN
    PLACE. Returns (u1, v1, t1, dp1, phi, vn0u, vn0v, omg), the first four
    assembled."""
    o = caar_packed(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp,
                    pecnd, vn0u, vn0v, omg, dvv, moist=moist)
    nlev = qdp.shape[1]
    assembled = dss_structured_scaled(torch.cat(o[:4], dim=1), plan, rsp_rows)
    return tuple(assembled[:, i * nlev:(i + 1) * nlev].contiguous()
                 for i in range(4)) + o[4:]


def caar_dss(state: State, derived: Derived, geom: Geometry,
             hv: HybridVCoord, plan: StructuredDssPlan, cfg: Config, dt2,
             eta_ave_w, moist: bool = True, device="cuda"):
    """Full-state assembled step on the row layout, the contract of
    ``caar_dss_t``: pack, ``caar_dss_structured_packed``, unpack.
    rspheremp is the geometry's, one f32 (or the state's dtype on the CPU)
    column. Returns (new_state, new_derived) on ``device``."""
    if cfg.rsplit <= 0:
        raise NotImplementedError("caar_dss ports the rsplit>0 path only")
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = pack_problem(state, derived, geom, hv, cfg, dtype)
    u1, v1, t1, dp1, phi, vn0u, vn0v, omg = caar_dss_structured_packed(
        _scalars(dt2, eta_ave_w, hv, dtype, dev), p["meta"], p["u0"],
        p["v0"], p["t0"], p["dp0"], p["um1"], p["vm1"], p["tm1"], p["dpm1"],
        p["qdp"], p["pecnd"], p["vn0u"], p["vn0v"], p["omg"], p["dvv"], plan,
        _rsp_row(geom, dtype).T.contiguous(), moist=moist)
    un = lambda x: unpack_field(x, cfg.nelem)

    def put(x, packed):
        out = x.clone()
        out[cfg.np1] = un(packed)
        return out

    new_state = dataclasses.replace(
        state, u=put(state.u, u1), v=put(state.v, v1), t=put(state.t, t1),
        dp3d=put(state.dp3d, dp1))
    new_derived = dataclasses.replace(
        derived, vn0_u=un(vn0u), vn0_v=un(vn0v), phi=un(phi),
        omega_p=un(omg))
    return new_state, new_derived


def _plain_dss_pre(x, slab, fix, rsp, mix=None):
    """Fixup and sweep from the plain versions alone."""
    return dss_sweep_plain(x, rsp, dss_fixup_plain(slab, fix, rsp), fix, mix)


def _cuda_patch(w, slab, fix, rsp, mix=None):
    """The ring's closer on the kernels: fixup, then the patch of w's fix
    lanes, in place."""
    return dss_merge_patch_cuda(w, dss_fixup_cuda(slab, fix, rsp), fix, mix)


def _plain_patch(w, slab, fix, rsp, mix=None):
    """The ring's closer from the plain versions alone (in place on w)."""
    return dss_merge_patch_plain(w, dss_fixup_plain(slab, fix, rsp), fix,
                                 mix)


def _mix_in_closer(step):
    """A two-launch producer (a CAAR or Euler step with the slab) in the
    ring producers' call form: rsp and the combination are the closer's."""
    return lambda *args, rsp, mix, **kw: step(*args, **kw)


def _ssprk3(produce, close, scal, meta, s0, qdp, pecnd, acc, dvv, plan, rsp,
            moist):
    """The three stages of ``ssprk3_packed_t4``, each a producer and its
    closer: ``produce`` is a CAAR stage in the call form of
    ``caar_ring_packed_t4`` (the ring itself, or a two-launch step through
    ``_mix_in_closer``), ``close(x, slab, fix, rsp, mix)`` completes the DSS
    (fixup + sweep, or fixup + patch). The stage weight scales eta_ave_w on
    the device (a copy of scal and one in-place product with a number: no
    host sync), rounded to the state's dtype as the JAX package's
    ``f.type(b)``. The mix coefficients are formed in the state's dtype,
    the last pair summing to exactly 1 (``third_stage_weights``)."""
    fix = fix_tables(plan, s0.device)
    f = np.float32 if s0.dtype == torch.float32 else np.float64

    def stage(u, b, acc, emit_phi=False, mix=None):
        sc = scal.clone()
        sc[0, 1].mul_(b)
        x, phi, *acc, slab = produce(
            sc, meta, u, None, qdp, pecnd, *acc, dvv, rsp=rsp, fix=fix,
            moist=moist, single=True, emit_phi=emit_phi, mix=mix)
        return close(x, slab, fix, rsp, mix), phi, acc

    u1, _, acc = stage(s0, B_WEIGHTS[0], acc)
    u2, _, acc = stage(u1, B_WEIGHTS[1], acc, mix=(s0, f(0.75), f(0.25)))
    u3, phi, acc = stage(u2, B_WEIGHTS[2], acc, emit_phi=True,
                         mix=(s0, *third_stage_weights(f)))
    return (u3, phi, *acc)


def ssprk3_packed_t4(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv,
                     plan: StructuredDssPlan, rsp: torch.Tensor,
                     moist: bool = True):
    """SSPRK3 dynamics on the stacked [4*nlev, E16] state (counterpart of
    ``ssprk3_packed_t4`` of the JAX package):

        U1 = P(U0 + dt L(U0))
        U2 = 3/4 U0 + 1/4 P(U1 + dt L(U1))
        U3 = 1/3 U0 + 2/3 P(U2 + dt L(U2))

    The projection P is pulled inside the convex combinations, which is
    exact when ``s0`` is CONTINUOUS (P U0 = U0), true of any state an
    assembled step produced. Each stage is one single-state CAAR launch
    with the slab, one fixup and one sweep whose affine output carries the
    combination: no standalone combination pass. ``scal`` carries dt (not
    the leapfrog 2*dt) in its dt2 slot; the accumulators advance with the
    weights (1/6, 1/6, 2/3) composed onto scal's eta_ave_w, IN PLACE; phi
    is the last stage's; s0 is not modified. Returns (s_np1, phi, vn0u,
    vn0v, omg)."""
    return _ssprk3(_mix_in_closer(caar_t4_cuda), _cuda_dss_pre(plan), scal,
                   meta, s0, qdp, pecnd, (vn0u, vn0v, omg), dvv, plan, rsp,
                   moist)


def ssprk3_packed_t4_plain(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv,
                           plan: StructuredDssPlan, rsp: torch.Tensor,
                           moist: bool = True):
    """``ssprk3_packed_t4`` from the plain versions on any device; pure.
    Returns (s_np1, phi, vn0u', vn0v', omg')."""
    return _ssprk3(_mix_in_closer(caar_t4_plain), _plain_dss_pre, scal, meta,
                   s0, qdp, pecnd, (vn0u, vn0v, omg), dvv, plan, rsp, moist)


def _hypervis(vlap, dss_pre, dvv, meta, uvt, plan, rsp, nu, dt, nlev,
              nu_ratio, subcycle):
    """The subcycles of ``apply_hypervis_packed_t`` on the given Laplacian
    and fixup + sweep. step = dt/subcycle * nu is formed in the field's
    dtype, as the JAX package forms it; the Laplacians and step stay
    separate factors, so real scales (nu ~ 1e15) do not overflow."""
    if uvt.shape[0] not in (3 * nlev, 4 * nlev):
        raise ValueError(f"hypervis: the field needs {3 * nlev} or "
                         f"{4 * nlev} rows, got {uvt.shape[0]}")
    fix = fix_tables(plan, uvt.device)
    f = np.float32 if uvt.dtype == torch.float32 else np.float64
    step = f(dt) / f(subcycle) * f(nu)

    def lap_dss(x, mix=None):
        lap, slab = vlap(meta, x, dvv, nlev, nu_ratio, fix=fix)
        return dss_pre(lap, slab, fix, rsp, mix)

    x = uvt
    for _ in range(subcycle):
        x = lap_dss(lap_dss(x), mix=(x, f(1.0), -step))
    return x


def apply_hypervis_packed_t(dvv, meta, uvt, plan: StructuredDssPlan,
                            rsp: torch.Tensor, nu, dt, nlev: int,
                            nu_ratio=1.0, subcycle: int = 1):
    """Biharmonic hyperviscosity on the (u, v, T) rows of ``uvt``
    (counterpart of ``apply_hypervis_packed_t`` of the JAX package): per
    subcycle two (weak-Laplacian kernel -> fixup -> sweep) passes, then
    X -= (dt/subcycle)*nu*grad^4(X) as the second sweep's affine output.
    ``uvt`` is the [3*nlev, E16] (u, v, T) stack, left as it is and a new
    stack returned, or the FULL [4*nlev, E16] prognostic buffer, updated IN
    PLACE and returned, its dp rows untouched (no slice or concat pass).
    ``nu``, ``dt`` and ``nu_ratio`` are numbers."""
    return _hypervis(vlap_cuda, _cuda_dss_pre(plan), dvv, meta, uvt, plan,
                     rsp, nu, dt, nlev, nu_ratio, subcycle)


def apply_hypervis_packed_t_plain(dvv, meta, uvt, plan: StructuredDssPlan,
                                  rsp: torch.Tensor, nu, dt, nlev: int,
                                  nu_ratio=1.0, subcycle: int = 1):
    """``apply_hypervis_packed_t`` from the plain versions on any device;
    pure: a [4*nlev] buffer comes back as a new tensor too."""
    return _hypervis(vlap_plain, _plain_dss_pre, dvv, meta, uvt, plan, rsp,
                     nu, dt, nlev, nu_ratio, subcycle)


def _cuda_dss_pre(plan):
    """Fixup and sweep on the kernels, in the call form of
    ``_plain_dss_pre``."""
    return lambda x, slab, fix, rsp, mix=None: dss_structured_t_cuda_pre(
        x, slab, plan, rsp, mix)


def _np_float(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _ssprk3_tracer(euler, limiter, close, dvv, meta, vu, vv, qdp, plan, rsp,
                   dt, nlev, limit, wind_rows, limit_iters):
    """The three stages of ``ssprk3_tracer_packed_t``: without the limiter
    ``euler`` in the call form of ``tracer_ring_packed_t`` (the ring, or a
    two-launch Euler step through ``_mix_in_closer``) and its closer
    ``close(x, slab, fix, rsp, mix)``; with it the limit kernel, closed with
    no combination. The Shu-Osher coefficients are formed in the tracers'
    dtype, the last pair summing to exactly 1 (``third_stage_weights``)."""
    fix = fix_tables(plan, qdp.device)
    f = _np_float(qdp.dtype)
    mixes = (None, (qdp, f(0.75), f(0.25)),
             (qdp, *third_stage_weights(f)))
    q = qdp
    for mix in mixes:
        if limit:
            # the limiter is nonlinear: P(L(combination, bounds(q))), the
            # combination inside the kernel and none in the sweep
            e, slab = limiter(meta, vu, vv, q, dvv, dt, nlev, mix=mix,
                              wind_rows=wind_rows, iters=limit_iters, fix=fix)
            q = close(e, slab, fix, rsp)
        else:
            # P is linear and P(qdp) = qdp: the combination rides the sweep
            e, slab = euler(meta, vu, vv, q, dvv, dt, nlev, rsp=rsp, fix=fix,
                            wind_rows=wind_rows, mix=mix)
            q = close(e, slab, fix, rsp, mix)
    return q


def ssprk3_tracer_packed_t(dvv, meta, vu, vv, qdp, plan: StructuredDssPlan,
                           rsp: torch.Tensor, dt, nlev: int,
                           limit: bool = False, wind_rows=(0, 0),
                           limit_iters: int = 2):
    """SSPRK3 tracer transport on the stacked [qsize*nlev, E16] tracers
    (counterpart of ``ssprk3_tracer_packed_t`` of the JAX package): each
    stage is the Euler kernel (spheremp folded in, the slab emitted) closed
    by fixup and sweep, together the continuous projection
    P = rsp*DSS(sph*.) of ``timeloop.tracer.ssprk3_tracer_step``. The convex
    combinations assume a CONTINUOUS qdp (P q = q, true after any projected
    step). ``limit`` applies the monotone mass-conserving limiter per stage
    in the fused limit kernel, in the field path's order P(L(combination,
    bounds(q_in))). The winds are the row blocks ``wind_rows`` of vu / vv
    (the [4*nlev] state as both with (0, 1): no slice copy); ``dt`` is a
    number. qdp is not modified. Returns the new qdp."""
    return _ssprk3_tracer(_mix_in_closer(tracer_euler_cuda), tracer_limit_cuda,
                          _cuda_dss_pre(plan), dvv, meta, vu, vv, qdp, plan,
                          rsp, dt, nlev, limit, wind_rows, limit_iters)


def ssprk3_tracer_packed_t_plain(dvv, meta, vu, vv, qdp,
                                 plan: StructuredDssPlan, rsp: torch.Tensor,
                                 dt, nlev: int, limit: bool = False,
                                 wind_rows=(0, 0), limit_iters: int = 2):
    """``ssprk3_tracer_packed_t`` from the plain versions on any device;
    pure."""
    return _ssprk3_tracer(_mix_in_closer(tracer_euler_plain),
                          tracer_limit_plain, _plain_dss_pre, dvv, meta, vu,
                          vv, qdp, plan, rsp, dt, nlev, limit, wind_rows,
                          limit_iters)


def caar_dss_ring_t4(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                     plan: StructuredDssPlan, rsp: torch.Tensor,
                     moist: bool = True):
    """The ring-fused assembled step (counterpart of ``caar_dss_ring_t4`` of
    the JAX package): ONE ring launch (the CAAR step and the merge-free
    sweep of its s1, with the slab), then the fixup and the in-place patch
    of the fix lanes. Operands and result as
    ``caar_dss_structured_packed_t4``, bit for bit the same."""
    fix = fix_tables(plan, s0.device)
    w, phi, vn0u, vn0v, omg, slab = caar_ring_packed_t4(
        scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv, rsp, fix,
        moist=moist)
    return _cuda_patch(w, slab, fix, rsp), phi, vn0u, vn0v, omg


def caar_dss_ring_t4_plain(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg,
                           dvv, plan: StructuredDssPlan, rsp: torch.Tensor,
                           moist: bool = True):
    """``caar_dss_ring_t4`` from the plain versions on any device; pure."""
    fix = fix_tables(plan, s0.device)
    w, phi, vn0u, vn0v, omg, slab = caar_ring_plain(
        scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv, rsp, fix,
        moist=moist)
    return _plain_patch(w, slab, fix, rsp), phi, vn0u, vn0v, omg


def ssprk3_ring_t4(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv,
                   plan: StructuredDssPlan, rsp: torch.Tensor,
                   moist: bool = True):
    """``ssprk3_packed_t4`` on the ring-fused path (counterpart of
    ``ssprk3_ring_t4`` of the JAX package): each stage is one ring launch in
    stage mode, the Shu-Osher combination in its emission, then the fixup
    and the patch. Operands and result as ``ssprk3_packed_t4``, bit for bit
    the same; s0 must be CONTINUOUS."""
    return _ssprk3(caar_ring_packed_t4, _cuda_patch, scal, meta, s0, qdp,
                   pecnd, (vn0u, vn0v, omg), dvv, plan, rsp, moist)


def ssprk3_ring_t4_plain(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv,
                         plan: StructuredDssPlan, rsp: torch.Tensor,
                         moist: bool = True):
    """``ssprk3_ring_t4`` from the plain versions on any device; pure."""
    return _ssprk3(caar_ring_plain, _plain_patch, scal, meta, s0, qdp, pecnd,
                   (vn0u, vn0v, omg), dvv, plan, rsp, moist)


def ssprk3_tracer_ring_t(dvv, meta, vu, vv, qdp, plan: StructuredDssPlan,
                         rsp: torch.Tensor, dt, nlev: int, wind_rows=(0, 0)):
    """``ssprk3_tracer_packed_t`` without the limiter on the ring-fused
    path (counterpart of ``ssprk3_tracer_ring_t`` of the JAX package): each
    stage one ring Euler launch, the combination in its emission, then the
    fixup and the patch. Operands and result as ``ssprk3_tracer_packed_t``
    (``limit=False``), bit for bit the same; qdp must be CONTINUOUS."""
    return _ssprk3_tracer(tracer_ring_packed_t, None, _cuda_patch, dvv, meta,
                          vu, vv, qdp, plan, rsp, dt, nlev, False, wind_rows,
                          2)


def ssprk3_tracer_ring_t_plain(dvv, meta, vu, vv, qdp,
                               plan: StructuredDssPlan, rsp: torch.Tensor, dt,
                               nlev: int, wind_rows=(0, 0)):
    """``ssprk3_tracer_ring_t`` from the plain versions on any device;
    pure."""
    return _ssprk3_tracer(tracer_ring_plain, None, _plain_patch, dvv, meta,
                          vu, vv, qdp, plan, rsp, dt, nlev, False, wind_rows,
                          2)


def _prim_step(dynamics, hypervis, tracers, scal, meta, s0, qdp, pecnd, acc,
               dvv, plan, rsp, nu, nlev, qsplit, nu_ratio, moist, subcycle,
               limit_tracers, limit_iters, dt):
    """The cadence of ``prim_step_packed_t4`` on the given three steps."""
    if qdp.shape[0] % nlev or s0.shape[0] != 4 * nlev:
        raise ValueError(f"prim step: s0 needs {4 * nlev} rows and qdp a "
                         f"multiple of {nlev}, got {s0.shape[0]} and "
                         f"{qdp.shape[0]}")
    if dt is None:
        dt = float(scal[0, 0])                   # waits for the device
    # the dynamics reads the moisture tracer: the first nlev rows, a view
    s1, phi, *acc = dynamics(scal, meta, s0, qdp[:nlev], pecnd, *acc, dvv,
                             plan, rsp, moist=moist)
    if nu:
        # the whole [4*nlev] buffer: the update lands in its (u, v, T) rows
        s1 = hypervis(dvv, meta, s1, plan, rsp, nu, dt, nlev,
                      nu_ratio=nu_ratio, subcycle=subcycle)
    # the tracers ride the new winds, row blocks 0 (u) and 1 (v) of s1
    nsub = max(qsplit, 1)
    f = _np_float(s0.dtype)
    dt_q = f(dt) / f(nsub)
    for _ in range(nsub):
        qdp = tracers(dvv, meta, s1, s1, qdp, plan, rsp, dt_q, nlev,
                      limit=limit_tracers, wind_rows=(0, 1),
                      limit_iters=limit_iters)
    return (s1, qdp, phi, *acc)


def prim_step_packed_t4(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv,
                        plan: StructuredDssPlan, rsp: torch.Tensor, nu,
                        nlev: int, qsplit: int = 1, nu_ratio=1.0,
                        moist: bool = True, subcycle: int = 1,
                        limit_tracers: bool = False, limit_iters: int = 2,
                        dt=None):
    """The full model step on the packed layout (counterpart of
    ``prim_step_packed_t4`` of the JAX package, the packed analog of
    ``timeloop.prim.prim_run_step``):

      1. SSPRK3 dynamics (``ssprk3_packed_t4``) on the stacked prognostics;
      2. with a nonzero ``nu`` biharmonic hyperviscosity, in place on the
         new state (``apply_hypervis_packed_t``);
      3. ``qsplit`` SSPRK3 tracer substeps of dt/qsplit riding the new
         winds (``ssprk3_tracer_packed_t``), tracers stacked
         [qsize*nlev, E16].

    ``scal`` carries dt in its dt2 slot; ``dt`` is the same step as a
    number, which hyperviscosity and the tracers take by value: pass it, or
    it is read back from ``scal``, which waits for the device once a step.
    Rows [0:nlev] of ``qdp`` are the moisture tracer the dynamics reads (a
    view, no slice copy). s0 and qdp must be CONTINUOUS and are not
    modified; the accumulators advance IN PLACE. Chain s_np1 -> s0, qdp' ->
    qdp. Returns (s_np1, qdp', phi, vn0u, vn0v, omg)."""
    return _prim_step(ssprk3_packed_t4, apply_hypervis_packed_t,
                      ssprk3_tracer_packed_t, scal, meta, s0, qdp, pecnd,
                      (vn0u, vn0v, omg), dvv, plan, rsp, nu, nlev, qsplit,
                      nu_ratio, moist, subcycle, limit_tracers, limit_iters,
                      dt)


def prim_step_packed_t4_plain(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg,
                              dvv, plan: StructuredDssPlan,
                              rsp: torch.Tensor, nu, nlev: int,
                              qsplit: int = 1, nu_ratio=1.0,
                              moist: bool = True, subcycle: int = 1,
                              limit_tracers: bool = False,
                              limit_iters: int = 2, dt=None):
    """``prim_step_packed_t4`` from the plain versions on any device; pure.
    Returns (s_np1, qdp', phi, vn0u', vn0v', omg')."""
    return _prim_step(ssprk3_packed_t4_plain, apply_hypervis_packed_t_plain,
                      ssprk3_tracer_packed_t_plain, scal, meta, s0, qdp,
                      pecnd, (vn0u, vn0v, omg), dvv, plan, rsp, nu, nlev,
                      qsplit, nu_ratio, moist, subcycle, limit_tracers,
                      limit_iters, dt)


def packed_air_mass(s: torch.Tensor, sph_lanes: torch.Tensor, nlev: int):
    """spheremp-weighted air mass of the stacked state's dp rows, in the
    state's dtype and a fixed summation order: the mass fixer's functional
    (measure the target and the current mass with it, so its bias cancels in
    the ratio). ``sph_lanes`` is [1, E16]."""
    return (sph_lanes * s[3 * nlev:4 * nlev]).sum()


def _check_remap(s, qdp, nelem: int, nlev: int, qsize: int):
    k = nlev
    if s.shape[0] != 4 * k or qdp.shape[0] != qsize * k \
            or s.shape[1] != nelem * 16 or qdp.shape[1] != s.shape[1]:
        raise ValueError(f"remap_packed_t4: s needs [{4 * k}, {nelem * 16}] "
                         f"and qdp [{qsize * k}, {nelem * 16}], got "
                         f"{tuple(s.shape)} and {tuple(qdp.shape)}")


def _fix_mass(s_new, q_new, nlev: int, sph_lanes, mass_target):
    """The global dry-mass fixer, in place on a remap's outputs."""
    if sph_lanes is not None and mass_target is not None:
        r = mass_target / packed_air_mass(s_new, sph_lanes, nlev)
        s_new[3 * nlev:] *= r
        q_new *= r
    return s_new, q_new


def remap_packed_t4(s: torch.Tensor, qdp: torch.Tensor, hv: HybridVCoord,
                    nelem: int, nlev: int, qsize: int, scheme: str = "plm",
                    sph_lanes=None, mass_target=None):
    """Conservative vertical remap of the stacked state s [4*nlev, E16] and
    tracers qdp [qsize*nlev, E16] from the Lagrangian dp rows back to the
    reference hybrid levels (``ops.remap.vertical_remap`` on the packed
    layout; call it every rsplit-th step). Returns new (s', qdp'). CUDA
    tensors take the remap kernel (``kernels.remap.remap_packed_cuda``, one
    launch; hv in s's dtype, every operand contiguous), CPU tensors
    ``remap_packed_t4_plain``.

    With ``sph_lanes`` [1, E16] and ``mass_target`` the global dry-mass
    fixer runs last: dp and qdp are rescaled by mass_target / the air mass
    of s', both measured by ``packed_air_mass`` so the f32 measurement bias
    cancels in the ratio (the f32 flux-form dynamics otherwise leaks about
    2e-8 of the relative mass a step)."""
    _check_remap(s, qdp, nelem, nlev, qsize)
    if s.device.type == "cpu":
        return remap_packed_t4_plain(s, qdp, hv, nelem, nlev, qsize, scheme,
                                     sph_lanes, mass_target)
    return _fix_mass(*remap_packed_cuda(s, qdp, hv, nlev, qsize, scheme),
                     nlev, sph_lanes, mass_target)


def remap_packed_t4_plain(s: torch.Tensor, qdp: torch.Tensor,
                          hv: HybridVCoord, nelem: int, nlev: int,
                          qsize: int, scheme: str = "plm", sph_lanes=None,
                          mass_target=None):
    """``remap_packed_t4`` by the dense plain remap on any device (hv may
    have another dtype than s); the fixer as there."""
    _check_remap(s, qdp, nelem, nlev, qsize)
    return _fix_mass(*remap_packed_plain(s, qdp, hv, nlev, qsize, scheme),
                     nlev, sph_lanes, mass_target)


def _rsp_row(geom: Geometry, dtype) -> torch.Tensor:
    # packed lane order is e*16 + i*4 + j == rspheremp[e, i, j] flattened
    return geom.rspheremp.to(dtype).reshape(1, -1).contiguous()


def ssprk3_t(state: State, derived: Derived, geom: Geometry,
             hv: HybridVCoord, plan: StructuredDssPlan, cfg: Config, dt,
             moist: bool = True, device="cuda"):
    """Full-state SSPRK3 step with the contract of ``timeloop.rk.
    ssprk3_step`` on the packed layout: pack, ``ssprk3_packed_t4``, unpack
    into time level np1. The n0 level must be continuous. rspheremp is the
    geometry's, one row. Returns (new_state, new_derived) on ``device``."""
    if cfg.rsplit <= 0:
        raise NotImplementedError("ssprk3_t ports the rsplit>0 path only")
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = pack_problem_t(state, derived, geom, hv, cfg, dtype)
    s0 = torch.cat([p["u0"], p["v0"], p["t0"], p["dp0"]])
    s1, phi, vn0u, vn0v, omg = ssprk3_packed_t4(
        _scalars(dt, 1.0, hv, dtype, dev), p["meta"], s0, p["qdp"],
        p["pecnd"], p["vn0u"], p["vn0v"], p["omg"], p["dvv"], plan,
        _rsp_row(geom, dtype), moist=moist)
    nelem, np1, k = cfg.nelem, cfg.np1, cfg.nlev

    def put(x, i):
        out = x.clone()
        out[np1] = unpack_field_t(s1[i * k:(i + 1) * k], nelem)
        return out

    new_state = dataclasses.replace(
        state, u=put(state.u, 0), v=put(state.v, 1), t=put(state.t, 2),
        dp3d=put(state.dp3d, 3))
    new_derived = dataclasses.replace(
        derived, vn0_u=unpack_field_t(vn0u, nelem),
        vn0_v=unpack_field_t(vn0v, nelem), phi=unpack_field_t(phi, nelem),
        omega_p=unpack_field_t(omg, nelem))
    return new_state, new_derived


def apply_hypervis_t(state: State, geom: Geometry, plan: StructuredDssPlan,
                     cfg: Config, nu, nu_div_ratio=1.0, dt=None,
                     subcycle: int = 1, device="cuda"):
    """Full-state hyperviscosity with the contract of ``timeloop.
    hyperviscosity.apply_hyperviscosity`` on the packed layout: pack u, v, T
    of time level np1, ``apply_hypervis_packed_t``, unpack. Returns the new
    state on ``device``."""
    dev, (state, geom) = _on(device, state, geom)
    dtype = state.u.dtype
    np1, k, nelem = cfg.np1, cfg.nlev, cfg.nelem
    uvt = torch.cat([pack_field_t(x[np1].to(dtype))
                     for x in (state.u, state.v, state.t)])
    out = apply_hypervis_packed_t(
        geom.dvv.to(dtype).contiguous(), pack_meta_t(geom, state.phis, dtype),
        uvt, plan, _rsp_row(geom, dtype), nu, cfg.dt if dt is None else dt,
        k, nu_ratio=nu_div_ratio, subcycle=subcycle)

    def put(x, i):
        new = x.clone()
        new[np1] = unpack_field_t(out[i * k:(i + 1) * k], nelem)
        return new

    return dataclasses.replace(state, u=put(state.u, 0), v=put(state.v, 1),
                               t=put(state.t, 2))


def prim_pack_t(state: State, derived: Derived, geom: Geometry,
                hv: HybridVCoord, cfg: Config, dt, dtype=None):
    """The operands of ``prim_step_packed_t4`` from a full state, on the
    state's device: dict of scal (dt in the dt2 slot, eta_ave_w = 1), meta,
    s0 (the n0 level, stacked), qdp (the qn0 level, all tracers stacked),
    pecnd, acc = (vn0u, vn0v, omg), dvv and rsp (the geometry's rspheremp,
    one row)."""
    from ..convert import pack_qdp_t

    dtype = dtype or state.u.dtype
    p = pack_problem_t(state, derived, geom, hv, cfg, dtype)
    return dict(
        scal=_scalars(dt, 1.0, hv, dtype, state.u.device), meta=p["meta"],
        s0=torch.cat([p["u0"], p["v0"], p["t0"], p["dp0"]]),
        qdp=pack_qdp_t(state, cfg, dtype), pecnd=p["pecnd"],
        acc=(p["vn0u"], p["vn0v"], p["omg"]), dvv=p["dvv"],
        rsp=_rsp_row(geom, dtype))


def prim_unpack_t(state: State, derived: Derived, cfg: Config, s1, qdp, phi,
                  acc):
    """Write a packed step's outputs into a full state: s1 into time level
    np1, the tracers into qdp level 1 - qn0, phi and the accumulators into
    the derived state. Returns new (state, derived); the inputs are not
    modified."""
    from ..convert import unpack_qdp_t

    nelem, np1, k = cfg.nelem, cfg.np1, cfg.nlev

    def put(x, i):
        out = x.clone()
        out[np1] = unpack_field_t(s1[i * k:(i + 1) * k], nelem)
        return out

    new_q = state.qdp.clone()
    new_q[1 - cfg.qn0] = unpack_qdp_t(qdp, nelem, k)
    new_state = dataclasses.replace(
        state, u=put(state.u, 0), v=put(state.v, 1), t=put(state.t, 2),
        dp3d=put(state.dp3d, 3), qdp=new_q)
    new_derived = dataclasses.replace(
        derived, vn0_u=unpack_field_t(acc[0], nelem),
        vn0_v=unpack_field_t(acc[1], nelem), phi=unpack_field_t(phi, nelem),
        omega_p=unpack_field_t(acc[2], nelem))
    return new_state, new_derived


def prim_t(state: State, derived: Derived, geom: Geometry, hv: HybridVCoord,
           plan: StructuredDssPlan, cfg: Config, nu=0.0, qsplit: int = 1,
           moist: bool = True, limit_tracers: bool = False,
           limit_iters: int = 2, device="cuda"):
    """Full-state model step of length cfg.dt with the contract of
    ``timeloop.prim.prim_run_step`` on the packed layout: pack,
    ``prim_step_packed_t4``, unpack into time level np1 and qdp level
    1 - qn0. The n0 level and qdp[qn0] must be continuous. Returns (state,
    derived, cfg) on ``device``, cfg carrying the rotated time levels with
    qn0 flipped."""
    if cfg.rsplit <= 0:
        raise NotImplementedError("prim_t ports the rsplit>0 path only")
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    p = prim_pack_t(state, derived, geom, hv, cfg, cfg.dt)
    s1, qdp, phi, *acc = prim_step_packed_t4(
        p["scal"], p["meta"], p["s0"], p["qdp"], p["pecnd"], *p["acc"],
        p["dvv"], plan, p["rsp"], nu, cfg.nlev, qsplit=qsplit, moist=moist,
        limit_tracers=limit_tracers, limit_iters=limit_iters, dt=cfg.dt)
    state, derived = prim_unpack_t(state, derived, cfg, s1, qdp, phi, acc)
    return state, derived, dataclasses.replace(rotated(cfg), qn0=1 - cfg.qn0)
