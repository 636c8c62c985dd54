"""The row-layout tracer Euler kernel (``csrc/tracer.cu``'s
``tracer_row_kernel``, ``euler_packed``) on the CPU: its launch plan
(``row_tracer_plan``: float4 columns where nlev % 4 == 0, else scalar
ones, and the tracers a block walks) and the refusals, the
wrapper's shape and alignment checks, and the kernel's walk and arithmetic
emulated (``euler_packed_emulated``): the grid writes every entry exactly
once, and the kernel's order agrees with JAX's ``euler_step_pallas`` in
interpret mode. The kernel runs only on the card, where ``chip_smoke.py``
phase 13 holds it to its plain version and bit for bit to the t-layout
kernel on the transposed problem.

Tolerance: 3e-6 scaled max-abs (the JAX package's own f32 limit,
tests/test_caar_pallas.py), on the output and on the increment alone, at
dt = 1e4 so that -dt*div carries the output (at a short step it sits below
f32 resolution of qdp)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.kernels.tracer_pallas import euler_step_pallas
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.device import from_arrays
from tinman_sandbox_tpu_torch.grid import Geometry
from tinman_sandbox_tpu_torch.kernels.layout import pack_field, pack_meta
from tinman_sandbox_tpu_torch.kernels.tracer import (
    ROW_QUADS,
    ROW_QUADS_NARROW,
    ROW_TRACERS,
    _check_row_aligned,
    euler_packed,
    euler_packed_emulated,
    euler_packed_plain,
    euler_step_fast,
    row_tracer_plan,
)

torch.set_num_threads(2)
F32_TOL = 3e-6


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _operands(ncol, nlev, nq, seed=0):
    """Random row-layout operands: meta [ncol, 16] with metdet in [1, 2],
    winds [ncol, nlev], q [ncol, nq*nlev], dvv [4, 4]."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(
        np.float32))
    meta = rnd(ncol, 16)
    meta[:, 8] = 1.0 + meta[:, 8].abs()
    return meta, rnd(ncol, nlev), rnd(ncol, nlev), rnd(ncol, nq * nlev), \
        rnd(4, 4)


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("nlev,vec", [(72, 4), (8, 4), (26, 1), (6, 1),
                                      (27, 1), (5, 1), (1, 1)])
def test_torch_row_tracer_plan_columns(nlev, vec):
    """float4 columns where nlev % 4 == 0, scalar columns otherwise; a
    level group a quad, 32 quads a block with float4 columns and 64 with
    scalar ones."""
    p = row_tracer_plan(nlev, 3, 16 * 7)
    per_block = ROW_QUADS if vec == 4 else ROW_QUADS_NARROW
    assert (p.vec, p.groups, p.quads) == (vec, nlev // vec, 7 * nlev // vec)
    assert p.threads == 4 * per_block
    assert p.blocks == -(-p.quads // per_block) * p.chunks


@pytest.mark.parametrize("nq", [1, 3, 4, 5, 9, 16, 35, 36])
def test_torch_row_tracer_plan_chunks(nq):
    """The tracers split into the fewest chunks of at most ROW_TRACERS, as
    even as they go, none empty: qsize 35 is 9 chunks of 4."""
    p = row_tracer_plan(72, nq, 86400)
    assert p.tracers <= ROW_TRACERS
    assert p.chunks == -(-nq // ROW_TRACERS)
    assert (p.chunks - 1) * p.tracers < nq <= p.chunks * p.tracers
    if nq == 35:
        assert (p.tracers, p.chunks, p.blocks) == (4, 9, 3038 * 9)


@pytest.mark.parametrize("args,match", [
    ((6, 1, 256, 4), "nlev % 4"),          # float4 columns need nlev % 4
    ((26, 1, 256, 4), "nlev % 4"),
    ((72, 1, 256, 2), "not 1 or 4"),
    ((72, 1, 250, None), "multiple of 16"),
    ((72, 0, 256, None), "nq >= 1"),
    ((0, 1, 256, None), "nlev, nq >= 1"),
])
def test_torch_row_tracer_plan_refusals(args, match):
    """The plan refuses float4 columns at nlev % 4 != 0 (the kernel would
    read across a tracer's columns) and shapes the kernel cannot take."""
    nlev, nq, ncol, vec = args
    with pytest.raises(ValueError, match=match):
        row_tracer_plan(nlev, nq, ncol, vec=vec)


@pytest.mark.parametrize("nlev,op,offset,ok", [
    (72, "qdp", 0, True), (72, "qdp", 1, False), (72, "qdp", 2, False),
    (72, "qdp", 4, True), (26, "qdp", 1, True), (27, "out", 3, True),
    (27, "meta", 1, False), (27, "dvv", 2, False), (72, "vu", 1, False),
    (72, "out", 2, False)])
def test_torch_row_tracer_alignment(nlev, op, offset, ok):
    """meta and dvv must be 16-byte aligned (float4 rows); q, out and the
    winds too with float4 columns, and need nothing more with scalar ones.
    ``offset`` floats into a larger buffer."""
    plan = row_tracer_plan(nlev, 2, 32)
    buf = torch.zeros(4096)
    ops = {name: buf[:64] for name in ("meta", "dvv", "vu", "vv", "qdp",
                                       "out")}
    ops[op] = buf[offset:offset + 64]
    if ok:
        _check_row_aligned(plan, **ops)
    else:
        with pytest.raises(ValueError, match=f"{op} must be"):
            _check_row_aligned(plan, **ops)


def _bad(meta, vu, vv, q, dvv, case):
    if case == "wind_shape":
        vu = vu[:, 1:]
    elif case == "q_columns":
        q = q[:, 1:].contiguous()
    elif case == "q_rows":
        q, meta, vu, vv = q[8:], meta[8:], vu[8:], vv[8:]
    elif case == "meta_shape":
        meta = meta[:, :8].contiguous()
    elif case == "dvv_shape":
        dvv = dvv[:3]
    elif case == "strided":
        q = torch.cat([q, q], 1)[:, ::2]
    elif case == "dtype_mix":
        vu = vu.double()
    elif case == "int":
        q = q.int()
    return meta, vu, vv, q, dvv


@pytest.mark.parametrize("case", ["wind_shape", "q_columns", "q_rows",
                                  "meta_shape", "dvv_shape", "strided",
                                  "dtype_mix", "int"])
def test_torch_row_tracer_wrapper_refuses(case):
    """euler_packed checks every operand's shape, dtype, device and
    contiguity before it dispatches, on the CPU as on the card."""
    args = _bad(*_operands(32, 8, 2), case)
    launches = euler_packed.launches
    with pytest.raises((ValueError, TypeError)):
        euler_packed(*args[:4], args[4], 0.1, 8)
    assert euler_packed.launches == launches


# -- the kernel's grid and arithmetic ----------------------------------------

@pytest.mark.parametrize("ncol,nlev,nq", [
    (16 * 37, 8, 35), (16 * 5, 27, 4), (16 * 24, 72, 1), (16 * 3, 6, 3),
    (16 * 40, 26, 9), (16, 72, 35)])
def test_torch_row_tracer_grid_writes_once(ncol, nlev, nq):
    """The kernel's grid (quads of element x level group, dead quads in the
    last block, tracer chunks) writes every entry of the output exactly
    once, and with float4 and scalar columns alike; the arithmetic
    is the t-layout kernel's (the same bits whatever the walk)."""
    meta, vu, vv, q, dvv = _operands(ncol, nlev, nq, seed=nlev)
    out, writes = euler_packed_emulated(meta, vu, vv, q, dvv, 1e4, nlev)
    assert torch.equal(writes, torch.ones_like(writes))
    for vec in {1, row_tracer_plan(nlev, nq, ncol).vec}:
        again, w = euler_packed_emulated(
            meta, vu, vv, q, dvv, 1e4, nlev,
            plan=row_tracer_plan(nlev, nq, ncol, vec=vec))
        assert torch.equal(w, writes) and torch.equal(again, out)
    assert _err(out, euler_packed_plain(meta, vu, vv, q, dvv, 1e4,
                                        nlev)) < F32_TOL


def _jax_problem(nelem, nlev, qsize):
    cfg = jt.Config(nelem=nelem, nlev=nlev, qsize=qsize, elem_block=8)
    g = jax.tree.map(lambda x: np.asarray(x, np.float32),
                     jt.random_geometry(cfg, seed=4))
    rng = np.random.default_rng(qsize + nlev)
    q = rng.uniform(0, 1, (nelem, qsize, nlev, 4, 4)).astype(np.float32)
    u, v = (rng.uniform(-1, 1, (nelem, nlev, 4, 4)).astype(np.float32)
            for _ in range(2))
    return cfg, g, q, u, v


@pytest.mark.parametrize("nlev", [6, 8])
@pytest.mark.parametrize("qsize", [1, 4, 35])
def test_torch_row_tracer_kernel_matches_pallas(nlev, qsize):
    """The kernel's order (``euler_packed_emulated``: the wind-metric
    products c1, c2 once a level, gv = c*q, the quad's D_x order) and
    ``euler_step_fast`` (the plain version on the CPU) against
    euler_step_pallas in interpret mode at nlev 6 (scalar columns) and 8
    (float4), the increment held on its own too."""
    nelem, dt = 16, 1e4
    cfg, g, q, u, v = _jax_problem(nelem, nlev, qsize)
    ref = np.asarray(euler_step_pallas(q, u, v, g, cfg, dt, interpret=True))
    tg = from_arrays(Geometry, {f.name: np.asarray(getattr(g, f.name))
                                for f in dataclasses.fields(g)},
                     device="cpu")
    T = torch.from_numpy
    got = euler_step_fast(T(q), T(u), T(v), tg,
                          Config(nelem=nelem, nlev=nlev, qsize=qsize), dt,
                          device="cpu")
    assert _err(got, ref) < F32_TOL
    assert _err(got - T(q), ref - q) < F32_TOL
    # the kernel's arithmetic on the packed operands euler_step_fast makes
    meta = pack_meta(tg, torch.zeros_like(tg.fcor), torch.float32)
    qp = T(q).permute(0, 3, 4, 1, 2).reshape(nelem * 16, qsize * nlev)
    emu, writes = euler_packed_emulated(
        meta, pack_field(T(u)), pack_field(T(v)), qp.contiguous(),
        tg.dvv.float().contiguous(), dt, nlev)
    assert torch.equal(writes, torch.ones_like(writes))
    emu = emu.reshape(nelem, 4, 4, qsize, nlev).permute(0, 3, 4, 1, 2)
    assert _err(emu, ref) < F32_TOL
    assert _err(emu - T(q), ref - q) < F32_TOL

