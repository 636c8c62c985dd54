"""The port's SSPRK3 dynamics against the JAX package's on the same numpy
inputs: the field-form step in f64, the CAAR kernel's single-state stage
mode, the sweep's affine ``mix`` output and the packed step as a whole, at
ne = 2 and 3 and a few levels, the JAX Pallas kernels in interpret mode.
Errors are scaled max-abs per output field, |a - b| / max|b|.

Tolerances: 1e-12 for the f64 field form (same math, only the einsum and
cumsum order differs); 3e-6 for one f32 CAAR stage (the tendencies are
summed in another order than the Pallas kernel's matrix-unit contractions,
as in tests/test_torch_caar.py); 1e-6 for the sweep with ``mix`` (XLA on the
CPU contracts the two-product sum into a fused multiply-add, the port rounds
each product on its own, as the kernel on the card does; the two-float
scale is one fmaf in both, ``dist.dss.mul_2f``); 2e-5 for the packed step
and for a 3-step chain against JAX's; 2e-4 (rtol and atol, the limit of
tests/test_structured_dss.py) for the packed f32 step against the port's
own f64-capable field form run in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.dss import dss_project as j_dss_project
from tinman_sandbox_tpu.dist.dss import rsp_2f as j_rsp_2f
from tinman_sandbox_tpu.dist.step_pallas import (
    apply_hypervis_packed_t as j_hypervis_packed,
    ssprk3_packed_t4 as j_ssprk3_packed,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_lanes_2f
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    _scalars as j_scalars,
    caar_pallas_packed_t4_rk as j_caar_rk,
    pack_problem_t as j_pack,
)
from tinman_sandbox_tpu.kernels.dss_pallas import dss_structured_t_pallas
from tinman_sandbox_tpu.timeloop.rk import ssprk3_step as j_ssprk3_step
from tinman_sandbox_tpu_torch import Config, bench
from tinman_sandbox_tpu_torch.convert import from_numpy, plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    continuity_error_t,
    make_structured_plan,
    ssprk3_packed_t4,
    ssprk3_packed_t4_plain,
    ssprk3_t,
)
from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda, caar_t4_plain
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_fixup_cuda,
    dss_structured_t_cuda,
    dss_sweep_cuda,
    dss_sweep_plain,
    fix_tables,
)
from tinman_sandbox_tpu_torch.kernels.hypervis_t import vlap_cuda
from tinman_sandbox_tpu_torch.timeloop import ssprk3_step

torch.set_num_threads(2)
F64_TOL = 1e-12
STAGE_TOL = 3e-6
MIX_TOL = 1e-6
STEP_TOL = 2e-5
FIELD_TOL = 2e-4


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _problem(ne, nlev, seed, dtype=np.float32, eb=8, continuous=True):
    """A JAX problem on the cubed sphere: random state with the n0 level
    projected onto the continuous space (the packed step's contract),
    random accumulators and pecnd (``seed + 1``). Returns (jcs, cfg, st,
    dv, g, hv)."""
    jcs = j_build(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=nlev, elem_block=eb)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    if continuous:
        gdof = jnp.asarray(jcs.gdof)

        def proj(x):
            x = np.array(x)
            x[cfg.n0] = np.asarray(j_dss_project(
                jnp.asarray(x[cfg.n0]), gdof, jcs.ndof, g.spheremp,
                g.rspheremp), dtype)
            return x

        st = dataclasses.replace(st, u=proj(st.u), v=proj(st.v),
                                 t=proj(st.t), dp3d=proj(st.dp3d))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 1)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(dtype)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    return jcs, cfg, st, dv, g, jt.analytic_hvcoord(cfg).astype(dtype)


def _packed(ne, nlev, seed, dt, eb=8, two_float=False):
    """Stacked operands for both packages: (jax side, port side, plans, rsp,
    jcs). The JAX side is (scal, consts, s0, qdp, pecnd, acc); the port
    side (scal, meta, s0, qdp, pecnd, acc, dvv) as tensors."""
    jcs, cfg, st, dv, g, hv = _problem(ne, nlev, seed, eb=eb)
    p = j_pack(st, dv, g, hv, cfg)
    s0 = np.concatenate([np.asarray(p[k]) for k in ("u0", "v0", "t0", "dp0")])
    scal = np.asarray(j_scalars(np.float32(dt), np.float32(1.0), hv))
    consts = tuple(p[k] for k in ("dxbt", "dybt", "ainct", "astrt", "bstrt",
                                  "meta"))
    acc = tuple(np.asarray(p[k]) for k in ("vn0u", "vn0v", "omg"))
    jside = (scal, consts, s0, np.asarray(p["qdp"]), np.asarray(p["pecnd"]),
             acc)
    T = lambda a: torch.from_numpy(np.array(a))
    tside = (T(scal), T(p["meta"]), T(s0), T(p["qdp"]), T(p["pecnd"]),
             tuple(T(a) for a in acc), T(np.asarray(g.dvv, np.float32)))
    jp = j_plan(jcs.gdof, ne)
    plan = plan_from_fields(jp.ne, jp.edges, jp.corner_rows)
    if two_float:
        rsp = j_rsp_lanes_2f(np.asarray(g.spheremp, np.float32), jcs.gdof,
                             jcs.ndof)
    else:
        rsp = np.asarray(g.rspheremp, np.float32).reshape(1, -1)
    return jside, tside, (jp, plan), np.ascontiguousarray(rsp), jcs, cfg


@pytest.mark.parametrize("mode", ["local", "projected", "two_float", "dry"])
def test_torch_ssprk3_step_f64_matches_jax(mode):
    """timeloop.ssprk3_step in f64 against JAX's: without a dof map, with
    the DSS projection per stage, with the two-float rspheremp, and dry."""
    jcs, cfg, st, dv, g, hv = _problem(2, 5, seed=3, dtype=np.float64,
                                       continuous=False)
    kw, tkw = {}, {}
    if mode != "local":
        kw = dict(gdof=jnp.asarray(jcs.gdof), ndof=jcs.ndof)
        tkw = dict(gdof=jcs.gdof, ndof=jcs.ndof)
    if mode == "two_float":
        hi, lo = j_rsp_2f(g.spheremp, jcs.gdof, jcs.ndof)
        kw["rsp2"] = (jnp.asarray(hi, jnp.float64), jnp.asarray(lo, jnp.float64))
        tkw["rsp2"] = (torch.from_numpy(hi).double(),
                       torch.from_numpy(lo).double())
    moist = mode != "dry"
    js, jd = j_ssprk3_step(st, dv, g, hv, cfg, 0.05, moist=moist, **kw)
    ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(g), _np(hv),
                                device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=cfg.nlev)
    s, d = ssprk3_step(ts, td, tg, th, tcfg, 0.05, moist=moist, device="cpu",
                       **tkw)
    for name in ("u", "v", "t", "dp3d"):
        e = _err(getattr(s, name)[cfg.np1], np.asarray(getattr(js, name))[
            cfg.np1])
        assert e < F64_TOL, (name, e)
        # the other time levels are untouched
        assert torch.equal(getattr(s, name)[cfg.n0], getattr(ts, name)[cfg.n0])
    for name in ("vn0_u", "vn0_v", "phi", "omega_p"):
        e = _err(getattr(d, name), getattr(jd, name))
        assert e < F64_TOL, (name, e)


def _ramp(cfg, hv, rsplit):
    """cfg at ``rsplit`` and hv with a hybi ramp (the analytic hvcoord's
    hybi is all zeros, which would hide the hybi * sdot term of rsplit=0)."""
    return (dataclasses.replace(cfg, rsplit=rsplit),
            dataclasses.replace(hv, hybi=np.linspace(0.0, 1.0, cfg.nlev + 1)))


@pytest.mark.parametrize("mode", ["local", "projected"])
def test_torch_ssprk3_step_rsplit0_f64_matches_jax(mode):
    """timeloop.ssprk3_step at rsplit=0 in f64 against JAX's, without and
    with the DSS projection per stage: every field at np1 and the derived
    state, the eta_dot_dpdn accumulator (advanced by the b-weighted stage
    fluxes) included, from a random nonzero accumulator."""
    jcs, cfg, st, dv, g, hv = _problem(2, 5, seed=3, dtype=np.float64,
                                       continuous=False)
    cfg, hv = _ramp(cfg, hv, 0)
    rng = np.random.default_rng(9)
    dv = dataclasses.replace(dv, eta_dot_dpdn=rng.uniform(
        -1, 1, dv.eta_dot_dpdn.shape))
    kw, tkw = {}, {}
    if mode == "projected":
        kw = dict(gdof=jnp.asarray(jcs.gdof), ndof=jcs.ndof)
        tkw = dict(gdof=jcs.gdof, ndof=jcs.ndof)
    js, jd = j_ssprk3_step(st, dv, g, hv, cfg, 0.05, **kw)
    ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(g), _np(hv),
                                device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=cfg.nlev, rsplit=0)
    s, d = ssprk3_step(ts, td, tg, th, tcfg, 0.05, device="cpu", **tkw)
    for name in ("u", "v", "t", "dp3d"):
        e = _err(getattr(s, name)[cfg.np1], np.asarray(getattr(js, name))[
            cfg.np1])
        assert e < F64_TOL, (name, e)
    for name in ("vn0_u", "vn0_v", "phi", "omega_p", "eta_dot_dpdn"):
        e = _err(getattr(d, name), getattr(jd, name))
        assert e < F64_TOL, (name, e)
    # the flux is real: the accumulator moved
    inc = np.asarray(jd.eta_dot_dpdn) - np.asarray(dv.eta_dot_dpdn)
    assert np.max(np.abs(inc)) > 1e-6
    assert _err(d.eta_dot_dpdn - td.eta_dot_dpdn, inc) < 1e-9


def test_torch_ssprk3_step_rsplit1_keeps_eta_dot_dpdn():
    """At rsplit>0 the stage fluxes are zero: the step leaves a nonzero
    eta_dot_dpdn accumulator bit for bit as it was, whatever hybi holds,
    and its other outputs do not depend on hybi (bit for bit)."""
    jcs, cfg, st, dv, g, hv = _problem(2, 5, seed=3, dtype=np.float64,
                                       continuous=False)
    rng = np.random.default_rng(9)
    dv = dataclasses.replace(dv, eta_dot_dpdn=rng.uniform(
        -1, 1, dv.eta_dot_dpdn.shape))
    tcfg = Config(nelem=cfg.nelem, nlev=cfg.nlev)
    outs = []
    for h in (hv, _ramp(cfg, hv, 1)[1]):
        ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(g), _np(h),
                                    device="cpu")
        s, d = ssprk3_step(ts, td, tg, th, tcfg, 0.05, gdof=jcs.gdof,
                           ndof=jcs.ndof, device="cpu")
        assert torch.equal(d.eta_dot_dpdn, td.eta_dot_dpdn)
        outs.append((s, d))
    (s0, d0), (s1, d1) = outs
    for name in ("u", "v", "t", "dp3d"):
        assert torch.equal(getattr(s0, name), getattr(s1, name))
    for name in ("vn0_u", "vn0_v", "phi", "omega_p"):
        assert torch.equal(getattr(d0, name), getattr(d1, name))


@pytest.mark.parametrize("emit_phi,slab", [(True, False), (False, False),
                                           (True, True), (False, True)])
def test_torch_caar_single_matches_pallas_rk(emit_phi, slab):
    """The CAAR stage mode (base state = evaluation state, sm1 ignored)
    against caar_pallas_packed_t4_rk in interpret mode, with and without
    phi and the slab; equal to the pair form given s0 twice."""
    nlev = 6
    (scal, consts, s0, qdp, pecnd, acc), tside, (_, plan), _, _, _ = _packed(
        2, nlev, seed=11, dt=0.1)
    ref = j_caar_rk(scal, *consts, s0, qdp, pecnd, *acc, eb=8, nlev=nlev,
                    emit_phi=emit_phi, interpret=True)
    tscal, tmeta, ts0, tqdp, tpec, tacc, dvv = tside
    fix = fix_tables(plan, "cpu") if slab else None
    counts = (caar_t4_cuda.launches, caar_t4_cuda.single_launches)
    kacc = [a.clone() for a in tacc]
    got = caar_t4_cuda(tscal, tmeta, ts0, None, tqdp, tpec, *kacc, dvv,
                       fix=fix, single=True, emit_phi=emit_phi)
    assert (caar_t4_cuda.launches, caar_t4_cuda.single_launches) == counts
    assert all(g is a for g, a in zip(got[2:5], kacc))        # in place
    pair = caar_t4_plain(tscal, tmeta, ts0, ts0, tqdp, tpec, *tacc, dvv,
                         fix=fix)
    plain = caar_t4_plain(tscal, tmeta, ts0, None, tqdp, tpec, *tacc, dvv,
                          fix=fix, single=True, emit_phi=emit_phi)
    for i, (a, b, c) in enumerate(zip(got, pair, plain)):
        if i == 1 and not emit_phi:
            assert a is None and c is None
            continue
        assert torch.equal(a, b) and torch.equal(a, c)
    names = ("s1", "phi", "vn0u", "vn0v", "omg")
    for name, a, b in zip(names, got, ref):
        if name == "phi" and not emit_phi:
            continue
        e = _err(a, b)
        assert e < STAGE_TOL, (name, e)
    for a, b in zip(got[0].split(nlev), np.split(np.asarray(ref[0]), 4)):
        assert _err(a, b) < STAGE_TOL
    if slab:
        assert torch.equal(got[5], got[0][:, fix.read_lanes.long()].T)


def test_torch_caar_single_rejects_missing_sm1():
    """Without ``single`` the base state is required."""
    _, tside, _, _, _, _ = _packed(2, 4, seed=2, dt=0.1)
    tscal, tmeta, ts0, tqdp, tpec, tacc, dvv = tside
    with pytest.raises(ValueError, match="sm1 is required"):
        caar_t4_cuda(tscal, tmeta, ts0, None, tqdp, tpec, *tacc, dvv)
    with pytest.raises(ValueError, match="rows"):
        caar_t4_cuda(tscal, tmeta, ts0[:8], None, tqdp, tpec, *tacc, dvv,
                     single=True)


@pytest.mark.parametrize("step", [caar_t4_cuda, caar_t4_plain])
def test_torch_caar_pair_form_always_stores_phi(step):
    """Only a stage may drop phi: the pair form without it is no mode of
    the kernel, and both the wrapper and the plain version refuse it."""
    _, tside, _, _, _, _ = _packed(2, 4, seed=2, dt=0.1)
    tscal, tmeta, ts0, tqdp, tpec, tacc, dvv = tside
    with pytest.raises(ValueError, match="emit_phi=False needs single"):
        step(tscal, tmeta, ts0, ts0, tqdp, tpec, *tacc, dvv, emit_phi=False)


@pytest.mark.parametrize("ne,two_float,taller", [
    (2, False, False), (2, True, False), (3, True, False),
    (2, False, True), (2, True, True), (3, False, True)])
def test_torch_sweep_mix_matches_pallas(ne, two_float, taller):
    """The sweep's affine output ca*mx + cb*assembled against
    dss_structured_t_pallas(mix=) in interpret mode: into a new tensor for
    an mx of x's height, IN PLACE into the first rows of a taller mx, whose
    further rows stay bit for bit."""
    k = 6
    _, _, (jp, plan), _, jcs, _ = _packed(ne, 2, seed=1, dt=0.1)
    g = jcs.geometry
    if two_float:
        rsp = j_rsp_lanes_2f(np.asarray(g.spheremp, np.float32), jcs.gdof,
                             jcs.ndof)
    else:
        rsp = np.asarray(g.rspheremp, np.float32).reshape(1, -1)
    rng = np.random.default_rng(30 + ne)
    e16 = jcs.nelem * 16
    x = rng.standard_normal((k, e16)).astype(np.float32)
    mx = rng.standard_normal((k + 2 if taller else k, e16)).astype(np.float32)
    ca, cb = np.float32(1.0 / 3.0), np.float32(-0.7)
    ref = np.asarray(dss_structured_t_pallas(
        jnp.asarray(x), jp, jnp.asarray(rsp), mix=(jnp.asarray(mx), ca, cb),
        interpret=True))
    assert ref.shape == mx.shape
    X, R = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(rsp))
    M = torch.from_numpy(mx.copy())
    counts = (dss_fixup_cuda.launches, dss_sweep_cuda.launches)
    got = dss_structured_t_cuda(X, plan, R, mix=(M, ca, cb))
    assert (dss_fixup_cuda.launches, dss_sweep_cuda.launches) == counts
    assert _err(got, ref) < MIX_TOL
    if taller:
        assert got is M                                      # in place
        assert np.array_equal(got[k:].numpy(), mx[k:])       # rows ride on
    else:
        assert got is not M and np.array_equal(M.numpy(), mx)
    # the pure plain version gives the same bits and leaves mx alone
    t = fix_tables(plan, "cpu")
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_extract_plain, dss_fixup_plain)
    vd = dss_fixup_plain(dss_extract_plain(X, t), t, R)
    M2 = torch.from_numpy(mx.copy())
    plain = dss_sweep_plain(X, R, vd, t, mix=(M2, ca, cb))
    assert torch.equal(plain, got) and np.array_equal(M2.numpy(), mx)
    # ca = 1, cb = 0 hands mx back; without mix the plain DSS
    assert torch.equal(dss_sweep_plain(X, R, vd, t, mix=(M2, 1.0, 0.0)), M2)


def test_torch_sweep_mix_rejects_bad_operands():
    _, _, (_, plan), rsp, jcs, _ = _packed(2, 2, seed=1, dt=0.1)
    t = fix_tables(plan, "cpu")
    e16 = jcs.nelem * 16
    x = torch.zeros(6, e16)
    R = torch.from_numpy(rsp)
    vd = torch.zeros(6, t.nfix)
    with pytest.raises(ValueError, match="mix field"):
        dss_sweep_cuda(x, R, vd, t, mix=(torch.zeros(4, e16), 1.0, 1.0))
    with pytest.raises(ValueError, match="mix field"):
        dss_sweep_cuda(x, R, vd, t, mix=(torch.zeros(6, e16 - 16), 1.0, 1.0))
    buf = torch.zeros(8, e16)
    with pytest.raises(ValueError, match="overlaps"):
        dss_sweep_cuda(buf[:6], R, vd, t, mix=(buf, 1.0, 1.0))
    with pytest.raises(ValueError, match="mix field"):
        dss_sweep_cuda(x, R, vd, t, mix=(torch.zeros(8, e16).double(), 1., 1.))


@pytest.mark.parametrize("ne,eb,two_float", [(2, 8, False), (2, 8, True),
                                             (3, 6, False)])
def test_torch_ssprk3_packed_t4_matches_jax(ne, eb, two_float):
    """The packed SSPRK3 step (the wrappers on CPU tensors, that is the
    plain versions) against JAX's in interpret mode: ne=2 runs JAX's
    producer-fused compact path, ne=3 its unfused fallback of odd ne; the
    port has one path. Equal bit for bit to the plain twin; every alias of
    a dof equal after the step; s0 untouched."""
    nlev, dt = 4, 0.02
    (scal, consts, s0, qdp, pecnd, acc), tside, (jp, plan), rsp, jcs, _ = \
        _packed(ne, nlev, seed=12, dt=dt, eb=eb, two_float=two_float)
    ref = j_ssprk3_packed(scal, *consts, s0, qdp, pecnd, *acc, jp,
                          jnp.asarray(rsp), eb=eb, nlev=nlev, interpret=True)
    tscal, tmeta, ts0, tqdp, tpec, tacc, dvv = tside
    R = torch.from_numpy(rsp)
    kacc = [a.clone() for a in tacc]
    got = ssprk3_packed_t4(tscal, tmeta, ts0, tqdp, tpec, *kacc, dvv, plan, R)
    assert all(g is a for g, a in zip(got[2:], kacc))         # in place
    assert np.array_equal(ts0.numpy(), s0)
    names = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg")
    pairs = list(zip(got[0].split(nlev), np.split(np.asarray(ref[0]), 4)))
    pairs += list(zip(got[1:], ref[1:]))
    errs = {n: _err(a, b) for n, (a, b) in zip(names, pairs)}
    assert max(errs.values()) < STEP_TOL, errs
    plain = ssprk3_packed_t4_plain(tscal, tmeta, ts0, tqdp, tpec, *tacc, dvv,
                                   plan, R)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert continuity_error_t(got[0], jcs.gdof) == 0.0


def test_torch_ssprk3_packed_matches_field_form():
    """The packed f32 step and its full-state wrapper against the port's
    own field-form ``ssprk3_step`` in f32 on a continuous state, at the
    2e-4 of tests/test_structured_dss.py."""
    nlev, dt = 4, 0.02
    jcs, cfg, st, dv, g, hv = _problem(2, nlev, seed=12)
    ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(g), _np(hv),
                                device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=nlev)
    rs, rd = ssprk3_step(ts, td, tg, th, tcfg, dt, gdof=jcs.gdof,
                         ndof=jcs.ndof, device="cpu")
    plan = make_structured_plan(jcs.gdof, 2)
    s, d = ssprk3_t(ts, td, tg, th, plan, tcfg, dt, device="cpu")
    for name in ("u", "v", "t", "dp3d"):
        np.testing.assert_allclose(
            getattr(s, name)[cfg.np1].numpy(),
            getattr(rs, name)[cfg.np1].numpy(), rtol=FIELD_TOL,
            atol=FIELD_TOL, err_msg=name)
        assert torch.equal(getattr(s, name)[cfg.n0], getattr(ts, name)[cfg.n0])
    for name in ("vn0_u", "vn0_v", "phi", "omega_p"):
        np.testing.assert_allclose(getattr(d, name).numpy(),
                                   getattr(rd, name).numpy(),
                                   rtol=FIELD_TOL, atol=FIELD_TOL,
                                   err_msg=name)
    # the wrapper is the packed step: same numbers as the JAX field form too
    js, _ = j_ssprk3_step(st, dv, g, hv, cfg, dt, gdof=jnp.asarray(jcs.gdof),
                          ndof=jcs.ndof)
    np.testing.assert_allclose(s.t[cfg.np1].numpy(), np.asarray(js.t)[cfg.np1],
                               rtol=FIELD_TOL, atol=FIELD_TOL)


def test_torch_dynamics_chain_matches_jax_chain():
    """Three chained dynamics steps (SSPRK3, then one hyperviscosity
    subcycle in place on the [4*nlev] state; s_np1 the next s0, accumulators
    chained): the port's bench loop against the same loop on JAX's steps."""
    # nu * dt sized to the ne2 sphere, whose grad^4 is ~1e-22 of the field
    nlev, nsteps, dt, nu = 4, 3, 0.02, 2e22
    (scal, consts, s0, qdp, pecnd, acc), tside, (jp, plan), rsp, jcs, _ = \
        _packed(2, nlev, seed=40, dt=dt)
    dxbt, dybt, meta = consts[0], consts[1], consts[5]
    for _ in range(nsteps):
        s0, phi, *acc = j_ssprk3_packed(
            scal, *consts, s0, qdp, pecnd, *acc, jp, jnp.asarray(rsp), eb=8,
            nlev=nlev, interpret=True)
        s0 = j_hypervis_packed(dxbt, dybt, meta, s0, jp, jnp.asarray(rsp),
                               nu, dt, eb=8, nlev=nlev, interpret=True)
    tscal, tmeta, ts0, tqdp, tpec, tacc, dvv = tside
    counts = [w.launches for w in (caar_t4_cuda, vlap_cuda, dss_sweep_cuda)]
    t1, tacc1, tphi = bench.run_dynamics(
        (tscal, tmeta, tqdp, tpec, dvv), ts0, [a.clone() for a in tacc],
        plan, torch.from_numpy(rsp), nsteps, nu, dt)
    assert [w.launches for w in (caar_t4_cuda, vlap_cuda,
                                 dss_sweep_cuda)] == counts
    for name, a, b in (("s", t1, s0), ("phi", tphi, phi),
                       *zip(("vn0u", "vn0v", "omg"), tacc1, acc)):
        e = _err(a, b)
        assert e < STEP_TOL, (name, e)
    for a, b in zip(t1.split(nlev), np.split(np.asarray(s0), 4)):
        assert _err(a, b) < STEP_TOL
    assert continuity_error_t(t1, jcs.gdof) == 0.0


def test_torch_bench_dynamics_problem_and_bytes():
    """The dynamics bench problem starts continuous, its chain equals
    explicit steps, and the byte count is the documented one."""
    const, s0, acc, plan, rsp = bench.make_dynamics_problem(2, 4, "cpu", 0.05)
    from tinman_sandbox_tpu_torch.dist import build_cubed_sphere

    cs = build_cubed_sphere(2, device="cpu")
    assert continuity_error_t(s0, cs.gdof) == 0.0
    assert float(const[0][0, 0]) == pytest.approx(0.05)
    scal, meta, qdp, pecnd, dvv = const
    a1 = ssprk3_packed_t4_plain(scal, meta, s0, qdp, pecnd, *acc, dvv, plan,
                                rsp)
    a2 = ssprk3_packed_t4_plain(scal, meta, a1[0], qdp, pecnd, *a1[2:], dvv,
                                plan, rsp)
    s2, acc2, phi = bench.run_dynamics(const, s0, [a.clone() for a in acc],
                                       plan, rsp, 2)
    assert torch.equal(s2, a2[0]) and torch.equal(phi, a2[1])
    for a, b in zip(acc2, a2[2:]):
        assert torch.equal(a, b)
    e16, slab = 86400, 2856 * 72
    assert bench.dynamics_bytes_per_step(30, 72, 2856) == \
        ((81 * 72 + 6) * e16 + 24 * slab) * 4
    assert bench.dynamics_bytes_per_step(30, 72, 2856, True) == \
        ((108 * 72 + 10) * e16 + 36 * slab) * 4
