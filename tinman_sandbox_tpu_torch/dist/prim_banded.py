"""The band-sharded full model step (counterpart of
``tinman_sandbox_tpu/dist/prim_banded.py``): the cadence of
``step_t.prim_step_packed_t4`` with every kernel run per shard and the DSS
the banded one of ``banded_t4.py``.

  * ``ssprk3_banded_t4``: SSPRK3 dynamics, each stage the CAAR kernel in
    its stage mode with the shard's slab and the banded DSS, whose sweep
    carries the Shu-Osher combination (``mix``); needs a CONTINUOUS s0;
  * ``hypervis_banded_t``: per subcycle two passes of the weak-Laplacian
    kernel and the banded DSS, the update x - step*grad^4(x) the second
    sweep's affine output, IN PLACE in a [4*nlev] state's first rows;
  * ``tracer_banded_t``: SSPRK3 tracer transport without the limiter, each
    stage the Euler kernel with the slab and the banded DSS; needs a
    CONTINUOUS qdp;
  * ``prim_step_banded_t4``: the three in order, ``qsplit`` tracer substeps
    riding the new winds (row blocks 0 and 1 of the new state).

Every [*, E16] operand is a list of the mesh's shards
(``sharded_t4.shard_packed_t4``); scal and dvv are whole. Each step is bit
for bit the single-device one and has a ``_plain`` twin (pure). The JAX
functions' ``eb`` and ``lg`` switches have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

from ..timeloop.rk import B_WEIGHTS, third_stage_weights
from .banded_t4 import _banded_fix, banded_dss
from .sharded_t4 import CUDA, PLAIN

__all__ = ["ssprk3_banded_t4", "ssprk3_banded_t4_plain", "hypervis_banded_t",
           "hypervis_banded_t_plain", "tracer_banded_t",
           "tracer_banded_t_plain", "prim_step_banded_t4",
           "prim_step_banded_t4_plain"]


def _np_float(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _mixes(mxs, coef):
    return None if coef is None else [(mx, *coef) for mx in mxs]


def _ssprk3(kit, scal, meta, s0, qdp, pecnd, acc, dvv, plan, rsp, mesh, m,
            moist, overlap):
    """The three stages of ``ssprk3_packed_t4`` over the mesh; acc one
    (vn0u, vn0v, omg) a shard."""
    fixes = _banded_fix(plan, m, mesh, s0)
    f = _np_float(s0[0].dtype)

    def stage(us, b, acc, emit_phi=False, coef=None):
        sc = scal.clone()
        sc[0, 1].mul_(b)
        outs = [kit.caar(sc, mt, u, None, q, pc, *a, dvv, moist=moist,
                         fix=fix, single=True, emit_phi=emit_phi)
                for mt, u, q, pc, a, fix in zip(meta, us, qdp, pecnd, acc,
                                                fixes)]
        xs = banded_dss(kit, mesh, plan, m, [o[0] for o in outs],
                        [o[5] for o in outs], rsp, _mixes(s0, coef),
                        overlap)
        return xs, [o[1] for o in outs], [tuple(o[2:5]) for o in outs]

    u1, _, acc = stage(s0, B_WEIGHTS[0], acc)
    u2, _, acc = stage(u1, B_WEIGHTS[1], acc, coef=(f(0.75), f(0.25)))
    u3, phi, acc = stage(u2, B_WEIGHTS[2], acc, emit_phi=True,
                         coef=third_stage_weights(f))
    return (u3, phi) + tuple(list(a) for a in zip(*acc))


def ssprk3_banded_t4(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv, plan,
                     rsp, mesh, m: int, moist: bool = True,
                     overlap: bool = False):
    """Band-sharded SSPRK3 dynamics (counterpart of ``ssprk3_banded_t4``):
    the contract of ``ssprk3_packed_t4`` over the mesh, lists of shards.
    Accumulators IN PLACE. Returns (s_np1, phi, vn0u, vn0v, omg)."""
    return _ssprk3(CUDA, scal, meta, s0, qdp, pecnd,
                   list(zip(vn0u, vn0v, omg)), dvv, plan, rsp, mesh, m,
                   moist, overlap)


def ssprk3_banded_t4_plain(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv,
                           plan, rsp, mesh, m: int, moist: bool = True,
                           overlap: bool = False):
    """``ssprk3_banded_t4`` from the plain versions; pure."""
    return _ssprk3(PLAIN, scal, meta, s0, qdp, pecnd,
                   list(zip(vn0u, vn0v, omg)), dvv, plan, rsp, mesh, m,
                   moist, overlap)


def _hypervis(kit, dvv, meta, uvt, plan, rsp, mesh, m, nu, dt, nlev,
              nu_ratio, subcycle, overlap):
    """The subcycles of ``apply_hypervis_packed_t`` over the mesh."""
    if uvt[0].shape[0] not in (3 * nlev, 4 * nlev):
        raise ValueError(f"hypervis: the field needs {3 * nlev} or "
                         f"{4 * nlev} rows, got {uvt[0].shape[0]}")
    fixes = _banded_fix(plan, m, mesh, uvt)
    f = _np_float(uvt[0].dtype)
    step = f(dt) / f(subcycle) * f(nu)

    def lap_dss(xs, mixes=None):
        outs = [kit.vlap(mt, x, dvv, nlev, nu_ratio, fix=fix)
                for mt, x, fix in zip(meta, xs, fixes)]
        return banded_dss(kit, mesh, plan, m, [o[0] for o in outs],
                          [o[1] for o in outs], rsp, mixes, overlap)

    x = uvt
    for _ in range(subcycle):
        x = lap_dss(lap_dss(x), _mixes(x, (f(1.0), -step)))
    return x


def hypervis_banded_t(dvv, meta, uvt, plan, rsp, mesh, m: int, nu, dt,
                      nlev: int, nu_ratio=1.0, subcycle: int = 1,
                      overlap: bool = False):
    """Band-sharded biharmonic hyperviscosity (counterpart of
    ``hypervis_banded_t``): the contract of ``apply_hypervis_packed_t``
    over the mesh; [4*nlev] shards are updated IN PLACE in their (u, v, T)
    rows, the dp rows untouched."""
    return _hypervis(CUDA, dvv, meta, uvt, plan, rsp, mesh, m, nu, dt, nlev,
                     nu_ratio, subcycle, overlap)


def hypervis_banded_t_plain(dvv, meta, uvt, plan, rsp, mesh, m: int, nu, dt,
                            nlev: int, nu_ratio=1.0, subcycle: int = 1,
                            overlap: bool = False):
    """``hypervis_banded_t`` from the plain versions; pure."""
    return _hypervis(PLAIN, dvv, meta, uvt, plan, rsp, mesh, m, nu, dt, nlev,
                     nu_ratio, subcycle, overlap)


def _tracer(kit, dvv, meta, vu, vv, qdp, plan, rsp, mesh, m, dt, nlev,
            wind_rows, overlap):
    """The three stages of ``ssprk3_tracer_packed_t`` (no limiter) over the
    mesh."""
    fixes = _banded_fix(plan, m, mesh, qdp)
    f = _np_float(qdp[0].dtype)
    q = qdp
    for coef in (None, (f(0.75), f(0.25)), third_stage_weights(f)):
        outs = [kit.euler(mt, u, v, x, dvv, dt, nlev, wind_rows=wind_rows,
                          fix=fix)
                for mt, u, v, x, fix in zip(meta, vu, vv, q, fixes)]
        q = banded_dss(kit, mesh, plan, m, [o[0] for o in outs],
                       [o[1] for o in outs], rsp, _mixes(qdp, coef),
                       overlap)
    return q


def tracer_banded_t(dvv, meta, vu, vv, qdp, plan, rsp, mesh, m: int, dt,
                    nlev: int, wind_rows=(0, 0), overlap: bool = False):
    """Band-sharded SSPRK3 tracer transport without the limiter
    (counterpart of ``tracer_banded_t``): the contract of
    ``ssprk3_tracer_packed_t(limit=False)`` over the mesh. Returns the new
    qdp shards."""
    return _tracer(CUDA, dvv, meta, vu, vv, qdp, plan, rsp, mesh, m, dt, nlev,
                   wind_rows, overlap)


def tracer_banded_t_plain(dvv, meta, vu, vv, qdp, plan, rsp, mesh, m: int,
                          dt, nlev: int, wind_rows=(0, 0),
                          overlap: bool = False):
    """``tracer_banded_t`` from the plain versions; pure."""
    return _tracer(PLAIN, dvv, meta, vu, vv, qdp, plan, rsp, mesh, m, dt,
                   nlev, wind_rows, overlap)


def _prim(kit, scal, meta, s0, qdp, pecnd, acc, dvv, plan, rsp, mesh, m, nu,
          nlev, qsplit, nu_ratio, moist, subcycle, overlap, dt):
    """The cadence of ``prim_step_packed_t4`` over the mesh."""
    if qdp[0].shape[0] % nlev or s0[0].shape[0] != 4 * nlev:
        raise ValueError(f"prim step: s0 needs {4 * nlev} rows and qdp a "
                         f"multiple of {nlev}, got {s0[0].shape[0]} and "
                         f"{qdp[0].shape[0]}")
    if dt is None:
        dt = float(scal[0, 0])                   # waits for the device
    s1, phi, *acc = _ssprk3(kit, scal, meta, s0, [q[:nlev] for q in qdp],
                            pecnd, acc, dvv, plan, rsp, mesh, m, moist,
                            overlap)
    if nu:
        s1 = _hypervis(kit, dvv, meta, s1, plan, rsp, mesh, m, nu, dt, nlev,
                       nu_ratio, subcycle, overlap)
    nsub = max(qsplit, 1)
    f = _np_float(s0[0].dtype)
    dt_q = f(dt) / f(nsub)
    for _ in range(nsub):
        qdp = _tracer(kit, dvv, meta, s1, s1, qdp, plan, rsp, mesh, m, dt_q,
                      nlev, (0, 1), overlap)
    return (s1, qdp, phi, *acc)


def prim_step_banded_t4(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg, dvv,
                        plan, rsp, mesh, m: int, nu, nlev: int,
                        qsplit: int = 1, nu_ratio=1.0, moist: bool = True,
                        subcycle: int = 1, overlap: bool = False, dt=None):
    """The band-sharded full model step (counterpart of
    ``prim_step_banded_t4``): the contract of ``prim_step_packed_t4`` over
    the mesh, every [*, E16] operand a list of shards. Returns (s_np1, qdp',
    phi, vn0u, vn0v, omg), lists of shards; bit for bit the single-device
    step's."""
    return _prim(CUDA, scal, meta, s0, qdp, pecnd,
                 list(zip(vn0u, vn0v, omg)), dvv, plan, rsp, mesh, m, nu,
                 nlev, qsplit, nu_ratio, moist, subcycle, overlap, dt)


def prim_step_banded_t4_plain(scal, meta, s0, qdp, pecnd, vn0u, vn0v, omg,
                              dvv, plan, rsp, mesh, m: int, nu, nlev: int,
                              qsplit: int = 1, nu_ratio=1.0,
                              moist: bool = True, subcycle: int = 1,
                              overlap: bool = False, dt=None):
    """``prim_step_banded_t4`` from the plain versions; pure."""
    return _prim(PLAIN, scal, meta, s0, qdp, pecnd,
                 list(zip(vn0u, vn0v, omg)), dvv, plan, rsp, mesh, m, nu,
                 nlev, qsplit, nu_ratio, moist, subcycle, overlap, dt)
