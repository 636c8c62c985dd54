"""The assembled step on the packed transposed layout: the CAAR kernel and
the structured DSS kernels (counterpart of the assembled-step parts of
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

The accumulators vn0u / vn0v / omg are updated IN PLACE, as by the CAAR
kernel (the plain stacked step is pure and returns new ones).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..grid import Geometry, HybridVCoord
from ..kernels.caar_t import (
    _on, _scalars, caar_packed_t, caar_t4_cuda, caar_t4_plain, pack_problem_t)
from ..kernels.dss import (
    dss_fixup_plain, dss_structured_t_cuda, dss_structured_t_cuda_pre,
    dss_sweep_plain, fix_tables)
from ..kernels.layout import unpack_field_t
from ..state import Derived, State
from .structured_dss import StructuredDssPlan

__all__ = ["caar_dss_structured_packed_t4",
           "caar_dss_structured_packed_t4_plain",
           "caar_dss_structured_packed_t", "caar_dss_t"]


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
    # packed lane order is e*16 + i*4 + j == rspheremp[e, i, j] flattened
    rsp = geom.rspheremp.to(dtype).reshape(1, -1).contiguous()
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
