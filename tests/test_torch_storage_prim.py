"""bf16 storage through the stage, tracer and sweep kernels: the operand
mixes that the JAX package's full step hands its kernels under ``bench
--prim / --rk --storage`` (bench.py:290-352), in the port against the JAX
package on the same numpy inputs (JAX's Pallas kernels in interpret mode,
which take the bf16 operands as they come), with the bench's problems, byte
counts and ``--limit-iters``.

The contracts: the CAAR stage mode with bf16 qdp and pecnd (contract a: the
first ``--prim`` step, every ``--rk`` step) and with an f32 qdp beside a
bf16 pecnd (contract b: later ``--prim`` steps, the tracers writing f32);
the Euler and limited tracer stages with a bf16 q (a first substep's stage
1) and the limited stage with a bf16 mix field (its stages 2 and 3); the
merged sweep with a bf16 mix field (the unlimited stages 2 and 3).

The JAX package forms the tracer step's Shu-Osher weights in the tracers'
dtype (step_pallas.py:530): in bf16, 1/3 + 2/3 = 1 + 2**-9, so its first
bf16 unlimited substep adds ~2**-9 of the tracer mass. The port forms them
in f32 with a last pair that sums to 1 (``third_stage_weights``). The tests
that hold the port's steps against JAX's patch JAX's pair in (bf16-rounded
on the unlimited path, f32-rounded on the limited path, whose weights JAX
takes as f32 scalars); one test shows the difference.

Tolerances, scaled max-abs |a - b| / max|b|: 3e-6 for one CAAR stage and
2e-5 for the packed steps (the f32 gates of tests/test_torch_rk.py and
tests/test_torch_prim.py: both packages compute in f32 after an exact
upcast, the sums in another order); 1e-6 of the input's mass for the
port's first bf16 substep (the f32 rounding of the projection); the plain
versions on bf16 operands equal them on the upcast operands bit for bit.
"""
import contextlib
import dataclasses
import importlib
import inspect
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.dss import dss_project as j_dss_project
from tinman_sandbox_tpu.dist.step_pallas import (
    prim_step_packed_t4 as j_prim_packed,
    ssprk3_packed_t4 as j_ssprk3_packed,
    ssprk3_tracer_packed_t as j_tracer_packed,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    _scalars as j_scalars,
    caar_pallas_packed_t4_rk as j_caar_rk,
    pack_problem_t as j_pack,
)
from tinman_sandbox_tpu.kernels.layout import block_derivative_ops
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field
from tinman_sandbox_tpu.kernels.layout import pack_meta_t as j_pack_meta
from tinman_sandbox_tpu_torch import bench
from tinman_sandbox_tpu_torch.convert import plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    continuity_error_t,
    prim_step_packed_t4,
    prim_step_packed_t4_plain,
    ssprk3_packed_t4,
    ssprk3_packed_t4_plain,
    ssprk3_tracer_packed_t,
    ssprk3_tracer_packed_t_plain,
)
from tinman_sandbox_tpu_torch.kernels.caar_t import (
    STAGE_PECND,
    caar_t4_cuda,
    caar_t4_plain,
)
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_fixup_cuda,
    dss_sweep_cuda,
    dss_sweep_nomerge_cuda,
    dss_sweep_plain,
    fix_tables,
)
from tinman_sandbox_tpu_torch.kernels.ring_fused import tracer_ring_packed_t
from tinman_sandbox_tpu_torch.kernels.tracer_t import (
    tracer_euler_cuda,
    tracer_euler_plain,
    tracer_limit_cuda,
    tracer_limit_plain,
)

torch.set_num_threads(2)
# the modules (the package's ``caar_t`` is the full-state function)
ct = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")
kdss = importlib.import_module("tinman_sandbox_tpu_torch.kernels.dss")
kt = importlib.import_module("tinman_sandbox_tpu_torch.kernels.tracer_t")
STAGE_TOL = 3e-6
STEP_TOL = 2e-5
MASS_TOL = 1e-6
NLEV = 4
NU = 1e22                 # visibly damps on the ne = 2 sphere
STEP_DT = 1.0e4           # a tracer step that f32 resolves (test_torch_tracer)
BF = torch.bfloat16
_WRAPPERS = (caar_t4_cuda, tracer_euler_cuda, tracer_limit_cuda,
             dss_fixup_cuda, dss_sweep_cuda)


def _T(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


def _problem(qsize=2, seed=5, dt=0.02):
    """ne 2, NLEV levels, ``qsize`` tracers: random state with the n0 level
    and the tracers projected onto the continuous space, random
    accumulators and pecnd (``seed + 1``), f32 operands packed by the JAX
    package. Returns a dict: the JAX side "j" = (scal, consts, s0, q, pecnd,
    acc), the port's "t" = (scal, meta, s0, q, pecnd, acc, dvv), the plans,
    rsp, the sphere and the packed winds (u, v of s0's first blocks)."""
    jcs = j_build(2)
    cfg = jt.Config(nelem=jcs.nelem, nlev=NLEV, elem_block=8, qsize=qsize,
                    dt=dt)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    gdof = jnp.asarray(jcs.gdof)

    def proj(x, level):
        x = np.array(x)
        x[level] = np.asarray(j_dss_project(
            jnp.asarray(x[level]), gdof, jcs.ndof, g.spheremp, g.rspheremp),
            np.float32)
        return x

    st = dataclasses.replace(
        st, u=proj(st.u, cfg.n0), v=proj(st.v, cfg.n0), t=proj(st.t, cfg.n0),
        dp3d=proj(st.dp3d, cfg.n0), qdp=proj(st.qdp, cfg.qn0))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 1)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(np.float32)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    p = j_pack(st, dv, g, hv, cfg)
    s0 = np.concatenate([np.asarray(p[k]) for k in ("u0", "v0", "t0", "dp0")])
    q = np.concatenate([np.asarray(j_pack_field(jnp.asarray(
        st.qdp[cfg.qn0, :, i]))) for i in range(qsize)])
    scal = np.asarray(j_scalars(np.float32(dt), np.float32(1.0), hv))
    consts = tuple(p[k] for k in ("dxbt", "dybt", "ainct", "astrt", "bstrt",
                                  "meta"))
    acc = tuple(np.asarray(p[k]) for k in ("vn0u", "vn0v", "omg"))
    jp = j_plan(jcs.gdof, 2)
    rsp = np.ascontiguousarray(
        np.asarray(g.rspheremp, np.float32).reshape(1, -1))
    return dict(
        j=(scal, consts, s0, q, np.asarray(p["pecnd"]), acc),
        t=(_T(scal), _T(p["meta"]), _T(s0), _T(q), _T(p["pecnd"]),
           tuple(_T(a) for a in acc), _T(np.asarray(g.dvv, np.float32))),
        jp=jp, plan=plan_from_fields(jp.ne, jp.edges, jp.corner_rows),
        rsp=rsp, jcs=jcs)


def _tracer_problem(qsize=2, seed=9):
    """The problem of tests/test_torch_tracer.py's packed tracer step, on
    which its f32 gates were set: ne 2, NLEV levels, random winds (time
    level 0, as they come) and tracers in [0, 1] projected onto the
    continuous space. Returns the JAX side (dxbt, dybt, meta, vu, vv, q),
    the port's (meta, vu, vv, q, dvv), both plans, rsp and the sphere."""
    jcs = j_build(2)
    cfg = jt.Config(nelem=jcs.nelem, nlev=NLEV, qsize=qsize, elem_block=8)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    qdp = np.asarray(j_dss_project(
        jnp.asarray(st.qdp[0]), jnp.asarray(jcs.gdof), jcs.ndof, g.spheremp,
        g.rspheremp), np.float32)
    dxb, dyb = block_derivative_ops(8, g.dvv, np.float32)
    meta = np.asarray(j_pack_meta(g, st.phis, jnp.float32))
    vu, vv = (np.asarray(j_pack_field(jnp.asarray(x[0])))
              for x in (st.u, st.v))
    q = np.concatenate([np.asarray(j_pack_field(jnp.asarray(qdp[:, i])))
                        for i in range(qsize)])
    jp = j_plan(jcs.gdof, 2)
    return dict(
        j=(jnp.asarray(dxb).T, jnp.asarray(dyb).T, jnp.asarray(meta),
           jnp.asarray(vu), jnp.asarray(vv), jnp.asarray(q)),
        t=(_T(meta), _T(vu), _T(vv), _T(q),
           _T(np.asarray(g.dvv, np.float32))),
        jp=jp, plan=plan_from_fields(jp.ne, jp.edges, jp.corner_rows),
        rsp=np.ascontiguousarray(np.asarray(g.rspheremp, np.float32).reshape(
            1, -1)), jcs=jcs)


@contextlib.contextmanager
def jax_weights(limit: bool, bf16_qdp: bool = True):
    """The port's packed steps with the JAX package's last Shu-Osher pair:
    f32(1/3) and f32(2/3) rounded on their own (the dynamics, the limited
    tracer path, whose weights JAX passes as f32 scalars, and an f32 qdp),
    and for the unlimited tracer path on a bf16 qdp the bf16 values
    (0.333984375, 0.66796875) that JAX forms in the tracers' dtype."""
    from tinman_sandbox_tpu_torch.dist import step_t

    def pair(f):
        tracer = inspect.stack()[1].function == "_ssprk3_tracer"
        if tracer and bf16_qdp and not limit:
            return tuple(f(float(torch.tensor(x, dtype=BF)))
                         for x in (1.0 / 3.0, 2.0 / 3.0))
        return f(1.0 / 3.0), f(2.0 / 3.0)

    with mock.patch.object(step_t, "third_stage_weights", pair):
        yield


def _mass(meta, x):
    """Global tracer mass sum(sph * q) in f64 over a packed field."""
    return float((meta[11].double() * x.double()).sum())


# -- the CAAR stage mode (row 5) ----------------------------------------------

@pytest.mark.parametrize("contract", ["a", "b"])
@pytest.mark.parametrize("emit_phi", [True, False])
def test_torch_caar_stage_bf16_matches_pallas_rk(contract, emit_phi):
    """The stage mode on a bf16 pecnd beside a bf16 (a) or f32 (b) qdp
    against ``caar_pallas_packed_t4_rk`` in interpret mode on the same bf16
    operands, with the slab: every output at 3e-6, f32, equal bit for bit to
    the plain version on the upcast operands."""
    p = _problem(qsize=1)
    scal, consts, s0, q, pecnd, acc = p["j"]
    jq = _jbf(q) if contract == "a" else q
    ref = j_caar_rk(scal, *consts, s0, jq, _jbf(pecnd), *acc, eb=8,
                    nlev=NLEV, emit_phi=emit_phi, interpret=True)
    tscal, meta, ts0, tq, tpec, tacc, dvv = p["t"]
    tq = tq.to(BF) if contract == "a" else tq
    fix = fix_tables(p["plan"], "cpu")
    got = caar_t4_cuda(tscal, meta, ts0, None, tq, tpec.to(BF),
                       *(a.clone() for a in tacc), dvv, fix=fix, single=True,
                       emit_phi=emit_phi)
    up = caar_t4_plain(tscal, meta, ts0, None, tq.float(),
                       tpec.to(BF).float(), *tacc, dvv, fix=fix, single=True,
                       emit_phi=emit_phi)
    for i, (a, b) in enumerate(zip(got, up)):
        if i == 1 and not emit_phi:
            assert a is None and b is None
            continue
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for i, (a, b) in enumerate(zip(got[:5], ref)):
        if i == 1 and not emit_phi:
            continue
        assert _err(a, b) < STAGE_TOL, (i, _err(a, b))


@pytest.mark.parametrize("contract", ["a", "b"])
def test_torch_ssprk3_packed_bf16_matches_jax(contract):
    """``ssprk3_packed_t4`` on a bf16 pecnd beside a bf16 (a, ``--rk
    --storage``) or f32 (b) qdp against JAX's step in interpret mode on the
    same operands: every output at 2e-5; bit for bit its plain twin;
    continuity exactly 0."""
    p = _problem(qsize=1)
    scal, consts, s0, q, pecnd, acc = p["j"]
    jq = _jbf(q) if contract == "a" else q
    ref = j_ssprk3_packed(scal, *consts, s0, jq, _jbf(pecnd), *acc, p["jp"],
                          jnp.asarray(p["rsp"]), eb=8, nlev=NLEV,
                          interpret=True)
    tscal, meta, ts0, tq, tpec, tacc, dvv = p["t"]
    tq = tq.to(BF) if contract == "a" else tq
    R = _T(p["rsp"])
    got = ssprk3_packed_t4(tscal, meta, ts0, tq, tpec.to(BF),
                           *(a.clone() for a in tacc), dvv, p["plan"], R)
    plain = ssprk3_packed_t4_plain(tscal, meta, ts0, tq, tpec.to(BF), *tacc,
                                   dvv, p["plan"], R)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    pairs = list(zip(got[0].split(NLEV), np.split(np.asarray(ref[0]), 4)))
    pairs += list(zip(got[1:], ref[1:]))
    errs = [_err(a, b) for a, b in pairs]
    assert max(errs) < STEP_TOL, errs
    assert continuity_error_t(got[0], p["jcs"].gdof) == 0.0


# -- the tracer substep (rows 11-14, 20/23) -----------------------------------

@pytest.mark.parametrize("limit", [False, True])
@pytest.mark.parametrize("dt", [0.02, STEP_DT])
def test_torch_tracer_substep_bf16_matches_jax(limit, dt):
    """``ssprk3_tracer_packed_t`` on a bf16 qdp (stage 1 reads it as q; the
    sweeps of stages 2 and 3, or with the limiter the limited kernel, read
    it as the mix field) against JAX's in interpret mode on the same bf16
    qdp, with JAX's weights patched in: the field and, at the long step,
    the increment at 2e-5 (tests/test_torch_tracer.py's problem and gates);
    f32 out; bit for bit the plain twin; continuity exactly 0."""
    p = _tracer_problem()
    dxbt, dybt, jmeta, jvu, jvv, jq = p["j"]
    nlev = NLEV
    ref = np.asarray(j_tracer_packed(
        dxbt, dybt, jmeta, jvu, jvv, _jbf(jq), p["jp"],
        jnp.asarray(p["rsp"]), dt, eb=8, nlev=nlev, limit=limit,
        interpret=True))
    meta, vu, vv, tq, dvv = p["t"]
    qb = tq.to(BF)
    R = _T(p["rsp"])
    with jax_weights(limit):
        got = ssprk3_tracer_packed_t(dvv, meta, vu, vv, qb, p["plan"], R, dt,
                                     nlev, limit=limit)
        plain = ssprk3_tracer_packed_t_plain(dvv, meta, vu, vv, qb,
                                             p["plan"], R, dt, nlev,
                                             limit=limit)
    assert got.dtype == torch.float32 and torch.equal(got, plain)
    assert _err(got, ref) < STEP_TOL
    if dt > 1.0:
        q0 = qb.float()
        assert float((got - q0).abs().max()) > 1e-3 * float(q0.abs().max())
        assert _err(got - q0, ref - q0.numpy()) < STEP_TOL
    assert continuity_error_t(got, p["jcs"].gdof) == 0.0


def test_torch_first_bf16_substep_conserves_mass():
    """Without JAX's weights the port's first bf16 unlimited substep keeps
    the tracer mass of its (upcast) input to f32 resolution; JAX's gains
    (1/3 + 2/3 in bf16) - 1 = 2**-9 of it, and the port with JAX's bf16 pair
    patched in gains the same."""
    p = _tracer_problem()
    dxbt, dybt, jmeta, jvu, jvv, jq = p["j"]
    ref = np.asarray(j_tracer_packed(
        dxbt, dybt, jmeta, jvu, jvv, _jbf(jq), p["jp"], jnp.asarray(p["rsp"]),
        0.02, eb=8, nlev=NLEV, interpret=True))
    meta, vu, vv, tq, dvv = p["t"]
    qb = tq.to(BF)
    R = _T(p["rsp"])
    m0 = _mass(meta, qb)
    got = ssprk3_tracer_packed_t(dvv, meta, vu, vv, qb, p["plan"], R, 0.02,
                                 NLEV)
    with jax_weights(False):
        biased = ssprk3_tracer_packed_t(dvv, meta, vu, vv, qb, p["plan"], R,
                                        0.02, NLEV)
    port = _mass(meta, got) / m0 - 1.0
    jax_gain = _mass(meta, torch.from_numpy(ref)) / m0 - 1.0
    assert abs(port) < MASS_TOL, port
    assert abs(jax_gain / 2.0 ** -9 - 1.0) < 0.02, jax_gain
    assert abs((_mass(meta, biased) / m0 - 1.0) / jax_gain - 1.0) < 1e-3


# -- the full step ------------------------------------------------------------

@pytest.mark.parametrize("limit", [False, True])
def test_torch_prim_step_bf16_matches_jax(limit):
    """Two chained ``prim_step_packed_t4`` steps from a bf16 qdp and pecnd
    (the JAX bench's ``--prim --storage``: the first step reads contract
    a, the second an f32 qdp beside the bf16 pecnd, contract b) against
    JAX's packed step in interpret mode, JAX's weights patched in: every
    output at 2e-5 after each step; bit for bit the plain twin; the tracers
    f32 after the first step; continuity exactly 0."""
    dt = 0.02
    p = _problem(qsize=2, dt=dt)
    scal, consts, s0, q, pecnd, acc = p["j"]
    jq, jpec = _jbf(q), _jbf(pecnd)
    tscal, meta, ts0, tq, tpec, tacc, dvv = p["t"]
    tq, tpec = tq.to(BF), tpec.to(BF)
    R = _T(p["rsp"])
    kacc = [a.clone() for a in tacc]
    for step in range(2):
        ref = j_prim_packed(scal, *consts, s0, jq, jpec, *acc, p["jp"],
                            jnp.asarray(p["rsp"]), NU, eb=8, nlev=NLEV,
                            limit_tracers=limit, interpret=True)
        ref = [np.asarray(r) for r in ref]
        with jax_weights(limit, bf16_qdp=step == 0):
            got = prim_step_packed_t4(tscal, meta, ts0, tq, tpec, *kacc, dvv,
                                      p["plan"], R, NU, NLEV,
                                      limit_tracers=limit, dt=dt)
            plain = prim_step_packed_t4_plain(
                tscal, meta, ts0, tq, tpec, *(a.clone() for a in tacc), dvv,
                p["plan"], R, NU, NLEV, limit_tracers=limit, dt=dt)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
        errs = [_err(a, b) for a, b in zip(got[0].split(NLEV),
                                           np.split(ref[0], 4))]
        errs += [_err(a, b) for a, b in zip(got[1].split(NLEV),
                                           np.split(ref[1], 2))]
        errs += [_err(a, b) for a, b in zip(got[2:], ref[2:])]
        assert max(errs) < STEP_TOL, (step, errs)
        assert got[1].dtype == torch.float32
        for x in got[:2]:
            assert continuity_error_t(x, p["jcs"].gdof) == 0.0
        # chain: s_np1 -> s0, qdp' -> qdp (f32 now), the same pecnd
        s0, jq, acc = ref[0], ref[1], tuple(ref[3:6])
        ts0, tq, kacc = got[0], got[1], list(got[3:6])
        tacc = tuple(a.clone() for a in kacc)


# -- the plain versions and the wrappers' contracts ---------------------------

def _tracer_operands(qsize=2):
    p = _problem(qsize=qsize)
    _, meta, s0, q, _, _, dvv = p["t"]
    mx = torch.rand(q.shape, generator=torch.Generator().manual_seed(4))
    return p, meta, s0, q, mx, dvv


@pytest.mark.parametrize("case", ["stage_a", "stage_b", "euler", "limit_q",
                                  "limit_mx", "sweep_mix"])
def test_torch_plain_on_bf16_is_plain_on_the_upcast(case):
    """Each plain version (and each wrapper on CPU tensors) on the bf16
    operands equals it on the same operands upcast, bit for bit."""
    p, meta, s0, q, mx, dvv = _tracer_operands()
    fix = fix_tables(p["plan"], "cpu")
    tscal, _, ts0, tq1, tpec, tacc, _ = _problem(qsize=1)["t"]
    kw = dict(wind_rows=(0, 1), fix=fix)
    R = _T(p["rsp"])
    calls = {
        "stage_a": lambda up: (caar_t4_plain, caar_t4_cuda, (
            tscal, meta, ts0, None, up(tq1.to(BF)), up(tpec.to(BF)),
            *(a.clone() for a in tacc), dvv), dict(single=True, fix=fix)),
        "stage_b": lambda up: (caar_t4_plain, caar_t4_cuda, (
            tscal, meta, ts0, None, tq1, up(tpec.to(BF)),
            *(a.clone() for a in tacc), dvv), dict(single=True, fix=fix)),
        "euler": lambda up: (tracer_euler_plain, tracer_euler_cuda, (
            meta, s0, s0, up(q.to(BF)), dvv, 200.0, NLEV), kw),
        "limit_q": lambda up: (tracer_limit_plain, tracer_limit_cuda, (
            meta, s0, s0, up(q.to(BF)), dvv, 200.0, NLEV), kw),
        "limit_mx": lambda up: (tracer_limit_plain, tracer_limit_cuda, (
            meta, s0, s0, q, dvv, 200.0, NLEV, (up(mx.to(BF)), 0.25, 0.75)),
            kw),
        "sweep_mix": lambda up: (dss_sweep_plain, dss_sweep_cuda, (
            q, R, dss_fixup_cuda(tracer_euler_cuda(
                meta, s0, s0, q, dvv, 0.1, NLEV, **kw)[1], fix, R), fix,
            (up(mx.to(BF)), 0.25, 0.75)), {}),
    }
    outs = []
    for up in (lambda x: x, lambda x: x.float()):
        # fresh operands for each call: the CAAR wrapper updates the
        # accumulators in place
        plain, _, args, kwargs = calls[case](up)
        _, wrapper, wargs, _ = calls[case](up)
        outs.append([plain(*args, **kwargs), wrapper(*wargs, **kwargs)])
    flat = lambda o: [x for x in (o if isinstance(o, tuple) else (o,))
                      if isinstance(x, torch.Tensor)]
    for bf_out, up_out in zip(*outs):
        for a, b in zip(flat(bf_out), flat(up_out)):
            assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("case,error,match", [
    ("stage_qdp_alone", ValueError, "stage mode"),
    ("pair_pecnd_alone", ValueError, "qdp is torch.float32 but pecnd"),
    ("limit_q_with_mix", ValueError, "q is torch.bfloat16"),
    ("limit_both", ValueError, "q is torch.bfloat16"),
    ("euler_f16_q", TypeError, "float16 [(]q[)]"),
    ("euler_bf16_winds", TypeError, "bfloat16 [(]vu[)]"),
    ("euler_bf16_meta", ValueError, "meta is torch.bfloat16"),
    ("tracer_ring", ValueError, "q is torch.bfloat16"),
    ("sweep_nomerge", ValueError, "merged sweep only"),
    ("sweep_taller", ValueError, "bfloat16 mix field must be"),
])
def test_torch_bf16_mixes_outside_the_contracts_are_refused(case, error,
                                                            match):
    """Every mix the JAX entry points do not produce is refused, naming the
    field: a bf16 qdp beside an f32 pecnd in the stage mode, a lone bf16
    pecnd in the pair form, a bf16 q beside a mix field in the limited
    stage, f16, bf16 winds or meta, the tracer ring's bf16 q, a bf16 mix
    field in the merge-free sweep or taller than x."""
    p, meta, s0, q, mx, dvv = _tracer_operands()
    fix = fix_tables(p["plan"], "cpu")
    tscal, _, ts0, tq1, tpec, tacc, _ = _problem(qsize=1)["t"]
    R = _T(p["rsp"])
    kw = dict(wind_rows=(0, 1))
    vd = dss_fixup_cuda(tracer_euler_cuda(meta, s0, s0, q, dvv, 0.1, NLEV,
                                          fix=fix, **kw)[1], fix, R)
    calls = {
        "stage_qdp_alone": lambda: caar_t4_cuda(
            tscal, meta, ts0, None, tq1.to(BF), tpec, *tacc, dvv,
            single=True),
        "pair_pecnd_alone": lambda: caar_t4_cuda(
            tscal, meta, ts0, ts0, tq1, tpec.to(BF), *tacc, dvv),
        "limit_q_with_mix": lambda: tracer_limit_cuda(
            meta, s0, s0, q.to(BF), dvv, 0.1, NLEV, mix=(mx, 0.5, 0.5), **kw),
        "limit_both": lambda: tracer_limit_cuda(
            meta, s0, s0, q.to(BF), dvv, 0.1, NLEV,
            mix=(mx.to(BF), 0.5, 0.5), **kw),
        "euler_f16_q": lambda: tracer_euler_cuda(
            meta, s0, s0, q.half(), dvv, 0.1, NLEV, **kw),
        "euler_bf16_winds": lambda: tracer_euler_cuda(
            meta, s0.to(BF), s0, q.to(BF), dvv, 0.1, NLEV, **kw),
        "euler_bf16_meta": lambda: tracer_euler_cuda(
            meta.to(BF), s0, s0, q, dvv, 0.1, NLEV, **kw),
        "tracer_ring": lambda: tracer_ring_packed_t(
            meta, s0, s0, q.to(BF), dvv, 0.1, NLEV, R, fix, **kw),
        "sweep_nomerge": lambda: dss_sweep_nomerge_cuda(
            q, R, fix, mix=(mx.to(BF), 0.5, 0.5)),
        "sweep_taller": lambda: dss_sweep_cuda(
            q[:NLEV], R, vd[:NLEV], fix, mix=(mx.to(BF), 0.5, 0.5)),
    }
    with pytest.raises(error, match=match):
        calls[case]()


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branches on CPU tensors: every check reports a
    card, the libraries are stand-ins that record each launch's arguments
    and the stream is a number."""
    from tinman_sandbox_tpu_torch.kernels import _build

    calls = {}

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls.setdefault(name, []).append(args)
                return 0
            return launch

    cuda = lambda *a, **kw: torch.device("cuda", 0)
    monkeypatch.setattr(ct, "_check", cuda)
    monkeypatch.setattr(kt, "_check", cuda)
    monkeypatch.setattr(kdss, "_check", cuda)
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    return calls


def test_torch_cuda_branches_pass_the_bf16_codes(fake_card):
    """On a card the stage mode hands ``caar_launch`` storage 1 (bf16 qdp
    and pecnd) or STAGE_PECND (a lone bf16 pecnd), the tracer stages their
    bf16 code (1: q, 2: the mix field) and the sweep its mix_bf16 flag,
    each with the bf16 operand's own address (no f32 copy), f32 outputs,
    and each such launch counts in ``storage_launches``."""
    p, meta, s0, q, mx, dvv = _tracer_operands()
    tscal, _, ts0, tq1, tpec, tacc, _ = _problem(qsize=1)["t"]
    R = _T(p["rsp"])
    fix = fix_tables(p["plan"], "cpu")
    count = lambda w: (w.launches, getattr(w, "storage_launches", 0))
    before = {w: count(w) for w in _WRAPPERS}
    for qx, code in ((tq1.to(BF), 1), (tq1, STAGE_PECND), (tq1, 0)):
        pec = tpec if code == 0 else tpec.to(BF)
        caar_t4_cuda(tscal, meta, ts0, None, qx, pec, *tacc, dvv, single=True)
        args = fake_card["caar_launch"].pop()
        assert args[37] == code and args[11:13] == (qx.data_ptr(),
                                                    pec.data_ptr())
    qb, mxb = q.to(BF), mx.to(BF)
    kw = dict(wind_rows=(0, 1), fix=fix)
    out, slab = tracer_euler_cuda(meta, s0, s0, qb, dvv, 0.1, NLEV, **kw)
    args = fake_card["tracer_euler_launch"].pop()
    assert args[15] == 1 and args[4] == qb.data_ptr()
    assert out.dtype == slab.dtype == torch.float32
    for qx, mix, code in ((qb, None, 1), (q, (mxb, 0.5, 0.5), 2),
                          (q, None, 0)):
        out, slab = tracer_limit_cuda(meta, s0, s0, qx, dvv, 0.1, NLEV,
                                      mix=mix, **kw)
        args = fake_card["tracer_limit_launch"].pop()
        assert args[16] == code and out.dtype == torch.float32
        if mix is not None:
            assert args[5] == mxb.data_ptr()
    vd = torch.zeros(2 * NLEV, fix.nfix)
    out = dss_sweep_cuda(q, R, vd, fix, mix=(mxb, 0.5, 0.5))
    args = fake_card["dss_sweep_launch"].pop()
    assert args[6] == mxb.data_ptr() and args[7] == 1
    assert out.dtype == torch.float32 and out.data_ptr() != mxb.data_ptr()
    after = {w: count(w) for w in _WRAPPERS}
    delta = {w.__name__: (after[w][0] - before[w][0],
                          after[w][1] - before[w][1]) for w in _WRAPPERS}
    assert delta == {"caar_t4_cuda": (3, 2), "tracer_euler_cuda": (1, 1),
                     "tracer_limit_cuda": (3, 2), "dss_fixup_cuda": (0, 0),
                     "dss_sweep_cuda": (1, 1)}, delta


# -- the bench ----------------------------------------------------------------

@pytest.mark.parametrize("storage", ["bf16_aux", "bf16_ro"])
def test_torch_bench_stage_problems_cast_after_the_init(storage):
    """``make_dynamics_problem`` and ``make_prim_problem`` in a bf16
    storage: qdp (every tracer) and pecnd bf16, bit for bit the f32
    problem's values cast, everything else the f32 problem's; "bf16_ro"
    equals "bf16_aux" in these modes (no nm1 state)."""
    f32 = bench.make_prim_problem(2, 3, "cpu", qsize=3)
    got = bench.make_prim_problem(2, 3, "cpu", qsize=3, storage=storage)
    (_, _, pec, _), _, qdp, _, _, _ = got
    assert qdp.dtype == pec.dtype == BF
    assert torch.equal(qdp, f32[2].to(BF))
    assert torch.equal(pec, f32[0][2].to(BF))
    assert torch.equal(got[1], f32[1]) and torch.equal(got[0][1], f32[0][1])
    d32 = bench.make_dynamics_problem(2, 3, "cpu")
    dyn = bench.make_dynamics_problem(2, 3, "cpu", storage=storage)
    assert dyn[0][2].dtype == dyn[0][3].dtype == BF
    assert torch.equal(dyn[0][2], d32[0][2].to(BF))
    assert torch.equal(dyn[0][3], d32[0][3].to(BF))
    assert torch.equal(dyn[1], d32[1])
    with pytest.raises(ValueError, match="storage"):
        bench.make_prim_problem(2, 3, "cpu", storage="bf16")


def test_torch_bench_stage_bytes_count_the_bf16_reads():
    """The stage modes' byte counts: each of the 3 dynamics stages reads
    pecnd at 2 bytes in a bf16 storage, and qdp too where it is bf16
    (``--rk``; the timed ``--prim`` steps read an f32 qdp); the root
    bench's count, which subtracts 2 or 6 fields once a step, is not
    copied."""
    ne, nlev, nfix = 3, 5, 100
    e16 = 6 * ne * ne * 16
    f32 = bench.dynamics_bytes_per_step(ne, nlev, nfix, True)
    for storage in ("bf16_aux", "bf16_ro"):
        assert bench.dynamics_bytes_per_step(
            ne, nlev, nfix, True, storage=storage) == f32 - 6 * 2 * e16 * nlev
        assert bench.dynamics_bytes_per_step(
            ne, nlev, nfix, True, storage=storage, bf16_qdp=False) == \
            f32 - 3 * 2 * e16 * nlev
        for qsize in (1, 35):
            assert bench.prim_bytes_per_step(
                ne, nlev, nfix, qsize, 2, True, storage=storage) == \
                bench.prim_bytes_per_step(ne, nlev, nfix, qsize, 2, True) \
                - 3 * 2 * e16 * nlev
    with pytest.raises(ValueError, match="storage"):
        bench.dynamics_bytes_per_step(ne, nlev, nfix, storage="f16")


@pytest.fixture
def cpu_card(monkeypatch):
    """The bench's main on the CPU (the kernels' plain versions run)."""
    from tinman_sandbox_tpu_torch import device
    from tinman_sandbox_tpu_torch.kernels import saxpby

    monkeypatch.setattr(device, "resolve_device",
                        lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(saxpby, "saxpby_bandwidth_gbs", lambda **kw: 1.0)


def test_torch_bench_limit_iters_reaches_the_step(cpu_card, capsys,
                                                  monkeypatch):
    """``--limit-iters N`` reaches ``prim_step_packed_t4(limit_iters=N)``
    on every step (warm-up and timed), is named in the config where N != 2,
    and changes the result; it is refused without ``--limit``."""
    from tinman_sandbox_tpu_torch.dist import step_t

    seen = []
    real = step_t.prim_step_packed_t4

    def spy(*args, **kw):
        seen.append(kw["limit_iters"])
        return real(*args, **kw)

    monkeypatch.setattr(step_t, "prim_step_packed_t4", spy)
    argv = ["--ne", "2", "--nlev", "3", "--prim", "--limit", "--qsize", "2",
            "--nexec", "2", "--reps", "1"]
    lines = {}
    for extra in ([], ["--limit-iters", "0"]):
        seen.clear()
        bench.main(argv + extra)
        lines[len(extra)] = json.loads(capsys.readouterr().out)
        assert seen == [0 if extra else 2] * 4
    assert "limit iters" not in lines[0]["config"]
    assert "limit iters=0" in lines[2]["config"]
    # the limiter's passes change the tracers: the default's and zero's
    const, s0, qdp, acc, plan, rsp = bench.make_prim_problem(2, 3, "cpu",
                                                             0.1, 2)
    runs = [bench.run_prim(const, s0, qdp, [a.clone() for a in acc], plan,
                           rsp, 1, dt=100.0, limit=True, limit_iters=n)[1]
            for n in (0, 2)]
    assert not torch.equal(*runs)
    for bad in (["--prim", "--limit-iters", "1"],
                ["--prim", "--limit", "--limit-iters", "-1"]):
        with pytest.raises(SystemExit) as e:
            bench.main(["--ne", "2"] + bad)
        assert e.value.code == 2
    assert "--limit-iters needs --limit" in capsys.readouterr().err
