"""The port's full model step (SSPRK3 dynamics, hyperviscosity, tracer
transport) against the JAX package's on the same numpy inputs: the field
form ``prim_run_step`` in f64, the packed ``prim_step_packed_t4`` against
JAX's packed step (Pallas kernels in interpret mode) and against the port's
own field form, the full-state wrapper ``prim_t``, and the bench's chained
rotation; at ne = 2 and a few levels. Errors are scaled max-abs per field,
|a - b| / max|b|.

Tolerances: 1e-12 for the f64 field form (same math; only einsum, cumsum and
sum orders differ); 2e-5 for the packed f32 step against JAX's, on every
field; 1e-3 of its own size for the increment of each block of the state and
of each tracer over a long step; 5e-4 (rtol and atol, the limit of
tests/test_structured_dss.py) for the packed f32 step against the field
form.

Scales: on the ne = 2 sphere grad^4 is ~1e-22 of a field, so a
hyperviscosity that acts at dt = 0.02 needs nu = 1e22 (JAX's own test passes
2.5e-4, which leaves the state untouched). A step of dt = 0.02 moves the
tracers by less than one f32 ulp, so what the step ADDS is held on a second
step of dt = 200 (with nu = 1e18: the same nu*dt), which moves the tracers
by ~3e-2 and dp, the stiffest field, by 5e-4 of itself: the increments agree
with JAX's to 1e-3 of their own size.
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu import fastpath
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.dss import dss_project as j_dss_project
from tinman_sandbox_tpu.dist.step_pallas import (
    prim_step_packed_t4 as j_prim_packed,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    _scalars as j_scalars,
    pack_problem_t as j_pack,
)
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field
from tinman_sandbox_tpu.timeloop.prim import air_mass as j_air_mass
from tinman_sandbox_tpu.timeloop.prim import prim_run_step as j_prim_run_step
from tinman_sandbox_tpu_torch import Config, bench
from tinman_sandbox_tpu_torch.convert import (
    from_numpy,
    pack_qdp_t,
    plan_from_fields,
)
from tinman_sandbox_tpu_torch.dist import (
    continuity_error_t,
    prim_pack_t,
    prim_step_packed_t4,
    prim_step_packed_t4_plain,
    prim_t,
    prim_unpack_t,
)
from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
from tinman_sandbox_tpu_torch.kernels.dss import dss_fixup_cuda, dss_sweep_cuda
from tinman_sandbox_tpu_torch.kernels.hypervis_t import vlap_cuda
from tinman_sandbox_tpu_torch.kernels.layout import pack_field_t
from tinman_sandbox_tpu_torch.kernels.tracer_t import (
    tracer_euler_cuda,
    tracer_limit_cuda,
)
from tinman_sandbox_tpu_torch.timeloop import air_mass, prim_run_step

torch.set_num_threads(2)
F64_TOL = 1e-12
STEP_TOL = 2e-5
FIELD_TOL = 5e-4
INC_TOL = 1e-3
NU = 1e22                 # visibly damps on the ne = 2 sphere
NLEV = 4


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _T(a):
    return torch.from_numpy(np.array(a))


def _problem(dt, dtype=np.float32, eb=8, qsize=2, seed=5, continuous=True):
    """The problem of tests/test_structured_dss.py's packed prim test: ne 2,
    4 levels, ``qsize`` tracers, random state, the n0 level and qdp[qn0]
    projected onto the continuous space. Returns (jcs, cfg, st, dv, g, hv),
    numpy leaves."""
    jcs = j_build(2)
    cfg = jt.Config(nelem=jcs.nelem, nlev=NLEV, elem_block=eb, qsize=qsize,
                    dt=dt)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    if continuous:
        gdof = jnp.asarray(jcs.gdof)

        def proj(x, level):
            x = np.array(x)
            x[level] = np.asarray(j_dss_project(
                jnp.asarray(x[level]), gdof, jcs.ndof, g.spheremp,
                g.rspheremp), dtype)
            return x

        st = dataclasses.replace(
            st, u=proj(st.u, cfg.n0), v=proj(st.v, cfg.n0),
            t=proj(st.t, cfg.n0), dp3d=proj(st.dp3d, cfg.n0),
            qdp=proj(st.qdp, cfg.qn0))
    dv = cast(jt.zero_derived(cfg))
    return jcs, cfg, st, dv, g, jt.analytic_hvcoord(cfg).astype(dtype)


def _torch_side(cfg, st, dv, g, hv):
    ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(g), _np(hv),
                                device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=cfg.nlev, qsize=cfg.qsize, dt=cfg.dt)
    return ts, td, tg, th, tcfg


# -- the field form in f64 ----------------------------------------------------

@pytest.mark.parametrize("nu,qsplit,limit", [
    (0.0, 1, False), (NU, 2, False), (NU, 1, True), (0.0, 3, True)])
def test_torch_prim_run_step_f64_matches_jax(nu, qsplit, limit):
    """timeloop.prim_run_step in f64 against JAX's, with and without
    hyperviscosity, tracer subcycling and the limiter: every prognostic
    level, the tracers, the derived state and the rotated cfg."""
    jcs, cfg, st, dv, g, hv = _problem(0.05, np.float64, continuous=False)
    js, jd, jcfg = j_prim_run_step(st, dv, g, hv, cfg, jnp.asarray(jcs.gdof),
                                   jcs.ndof, nu=nu, qsplit=qsplit,
                                   limit_tracers=limit)
    ts, td, tg, th, tcfg = _torch_side(cfg, st, dv, g, hv)
    keep = ts.qdp.clone()
    s, d, c = prim_run_step(ts, td, tg, th, tcfg, jcs.gdof, jcs.ndof, nu=nu,
                            qsplit=qsplit, limit_tracers=limit, device="cpu")
    assert (c.n0, c.np1, c.nm1, c.qn0) == (jcfg.n0, jcfg.np1, jcfg.nm1,
                                           jcfg.qn0)
    assert c.qn0 == 1 - tcfg.qn0
    for name in ("u", "v", "t", "dp3d", "qdp"):
        e = _err(getattr(s, name), getattr(js, name))
        assert e < F64_TOL, (name, e)
    q0, q1 = np.asarray(st.qdp[cfg.qn0]), np.asarray(js.qdp[1 - cfg.qn0])
    assert _err(s.qdp[1 - tcfg.qn0] - ts.qdp[tcfg.qn0], q1 - q0) < 1e-8
    for name in ("vn0_u", "vn0_v", "phi", "omega_p"):
        e = _err(getattr(d, name), getattr(jd, name))
        assert e < F64_TOL, (name, e)
    assert torch.equal(ts.qdp, keep)                    # the input lives on
    # the mass fixer's functional
    want = float(j_air_mass(js, g.spheremp, cfg))
    assert abs(float(air_mass(s, tg.spheremp, tcfg)) / want - 1.0) < F64_TOL


def test_torch_prim_run_step_remap_not_ported():
    """remap=True (once not ported, now the vertical remap and the mass
    fixer) against JAX's prim_run_step in f64 on physically monotone eta
    levels, without and with a mass target: every level, the tracers, and
    the fixed air mass equal to the target."""
    from tinman_sandbox_tpu.grid import HybridVCoord as JHybridVCoord
    from tinman_sandbox_tpu_torch.device import from_arrays
    from tinman_sandbox_tpu_torch.grid import HybridVCoord

    jcs, cfg, st, dv, g, _ = _problem(20.0, np.float64, continuous=False)
    eta = np.linspace(0.0, 1.0, NLEV + 1)
    hva = dict(ps0=1000.0, hyai=0.1 * (1 - eta), hybi=eta,
               hyam=0.05 * ((1 - eta[:-1]) + (1 - eta[1:])),
               hybm=0.5 * (eta[:-1] + eta[1:]))
    hv = JHybridVCoord(**hva)
    ts, td, tg, _, tcfg = _torch_side(cfg, st, dv, g, hv)
    th = from_arrays(HybridVCoord, hva, device="cpu")
    jtarget = j_air_mass(st, jnp.asarray(g.spheremp),
                         dataclasses.replace(cfg, np1=cfg.n0))
    for target in (None, jtarget):
        js, jd, jcfg = j_prim_run_step(st, dv, g, hv, cfg,
                                       jnp.asarray(jcs.gdof), jcs.ndof,
                                       nu=NU, limit_tracers=True, remap=True,
                                       mass_target=target)
        tt = None if target is None else float(target)
        s, d, c = prim_run_step(ts, td, tg, th, tcfg, jcs.gdof, jcs.ndof,
                                nu=NU, limit_tracers=True, remap=True,
                                mass_target=tt, device="cpu")
        assert (c.n0, c.np1, c.nm1, c.qn0) == (jcfg.n0, jcfg.np1, jcfg.nm1,
                                               jcfg.qn0)
        for name in ("u", "v", "t", "dp3d", "qdp"):
            e = _err(getattr(s, name), getattr(js, name))
            assert e < F64_TOL, (name, target is None, e)
        if target is not None:
            m = float(air_mass(s, tg.spheremp, tcfg))
            assert abs(m / tt - 1.0) < F64_TOL


# -- the packed step ----------------------------------------------------------

def _packed(dt, qsize=2):
    """Stacked f32 operands of the packed prim step for both packages."""
    jcs, cfg, st, dv, g, hv = _problem(dt, qsize=qsize)
    p = j_pack(st, dv, g, hv, cfg)
    s0 = np.concatenate([np.asarray(p[k]) for k in ("u0", "v0", "t0", "dp0")])
    q0 = np.concatenate([np.asarray(j_pack_field(jnp.asarray(
        st.qdp[cfg.qn0, :, i]))) for i in range(qsize)])
    scal = np.asarray(j_scalars(np.float32(dt), np.float32(1.0), hv))
    consts = tuple(p[k] for k in ("dxbt", "dybt", "ainct", "astrt", "bstrt",
                                  "meta"))
    acc = tuple(np.asarray(p[k]) for k in ("vn0u", "vn0v", "omg"))
    rsp = np.ascontiguousarray(
        np.asarray(g.rspheremp, np.float32).reshape(1, -1))
    jp = j_plan(jcs.gdof, 2)
    return dict(
        j=(scal, consts, s0, q0, np.asarray(p["pecnd"]), acc),
        t=(_T(scal), _T(p["meta"]), _T(s0), _T(q0), _T(p["pecnd"]),
           tuple(_T(a) for a in acc), _T(np.asarray(g.dvv, np.float32))),
        jp=jp, plan=plan_from_fields(jp.ne, jp.edges, jp.corner_rows),
        rsp=rsp, jcs=jcs, cfg=cfg, problem=(st, dv, g, hv))


_WRAPPERS = (caar_t4_cuda, vlap_cuda, tracer_euler_cuda, tracer_limit_cuda,
             dss_fixup_cuda, dss_sweep_cuda)


@contextlib.contextmanager
def jax_third_stage():
    """The port's packed steps with the JAX package's last Shu-Osher pair,
    f(1/3) and f(2/3) rounded on their own (1 + 2**-25 together in
    float32), in place of the port's pair that sums to exactly 1
    (``timeloop.rk.third_stage_weights``): held against JAX's step, the
    increments are then compared at their own tolerance."""
    from tinman_sandbox_tpu_torch.dist import step_t

    with mock.patch.object(step_t, "third_stage_weights",
                           lambda f: (f(1.0 / 3.0), f(2.0 / 3.0))):
        yield


def _both(p, nu, qsplit, limit, dt):
    """One packed step by JAX (interpret) and by the port (the wrappers on
    CPU tensors, which launch nothing). Returns (got, ref), each (s1, qdp,
    phi, vn0u, vn0v, omg)."""
    scal, consts, s0, q0, pecnd, acc = p["j"]
    ref = j_prim_packed(scal, *consts, s0, q0, pecnd, *acc, p["jp"],
                        jnp.asarray(p["rsp"]), nu, eb=8, nlev=NLEV,
                        qsplit=qsplit, limit_tracers=limit, interpret=True)
    tscal, meta, ts0, tq0, tpec, tacc, dvv = p["t"]
    keep = (ts0.clone(), tq0.clone())
    counts = [w.launches for w in _WRAPPERS]
    kacc = [a.clone() for a in tacc]
    with jax_third_stage():
        got = prim_step_packed_t4(tscal, meta, ts0, tq0, tpec, *kacc, dvv,
                                  p["plan"], _T(p["rsp"]), nu, NLEV,
                                  qsplit=qsplit, limit_tracers=limit, dt=dt)
        plain = prim_step_packed_t4_plain(tscal, meta, ts0, tq0, tpec, *tacc,
                                          dvv, p["plan"], _T(p["rsp"]), nu,
                                          NLEV, qsplit=qsplit,
                                          limit_tracers=limit, dt=dt)
        # dt read back from scal gives the same bits as dt by value
        again = prim_step_packed_t4_plain(tscal, meta, ts0, tq0, tpec, *tacc,
                                          dvv, p["plan"], _T(p["rsp"]), nu,
                                          NLEV, qsplit=qsplit,
                                          limit_tracers=limit)
    assert [w.launches for w in _WRAPPERS] == counts
    assert torch.equal(ts0, keep[0]) and torch.equal(tq0, keep[1])
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    return got, [np.asarray(r) for r in ref]


_NAMES = ("s1", "qdp", "phi", "vn0u", "vn0v", "omg")


@pytest.mark.parametrize("nu,qsplit,limit", [
    (NU, 2, False), (0.0, 1, False), (NU, 1, True), (NU, 2, True)])
def test_torch_prim_step_packed_matches_jax(nu, qsplit, limit):
    """prim_step_packed_t4 against JAX's packed step in interpret mode on
    the problem of tests/test_structured_dss.py (ne 2, 4 levels, 2 tracers,
    projected start), at JAX's dt = 0.02: every output at 2e-5, each block of
    the state and each tracer on its own, continuity exactly 0. The limited
    cases assert that JAX took its fused limit kernel."""
    dt = 0.02
    p = _packed(dt)
    if limit:
        # the path is noted when JAX traces the step: trace it anew
        jax.clear_caches()
        fastpath.last_path.pop("ssprk3_tracer_packed_t(limit)", None)
    got, ref = _both(p, nu, qsplit, limit, dt)
    if limit:
        assert fastpath.last_path.get("ssprk3_tracer_packed_t(limit)",
                                      "").startswith("fused")
    for name, a, b in zip(_NAMES, got, ref):
        e = _err(a, b)
        assert e < STEP_TOL, (name, e)
    for a, b in zip(got[0].split(NLEV), np.split(ref[0], 4)):
        assert _err(a, b) < STEP_TOL
    for a, b in zip(got[1].split(NLEV), np.split(ref[1], 2)):
        assert _err(a, b) < STEP_TOL
    gdof = p["jcs"].gdof
    assert continuity_error_t(got[0], gdof) == 0.0
    assert continuity_error_t(got[1], gdof) == 0.0


@pytest.mark.parametrize("limit", [False, True])
def test_torch_prim_step_packed_increment_matches_jax(limit):
    """The same at a step long enough for f32 to resolve what the step adds
    (dt = 200, nu*dt as above): every output at 2e-5, and the increments
    s1 - s0 (each block) and qdp' - qdp (each tracer) at 1e-3 of JAX's, so
    a dropped term fails."""
    dt, nu = 200.0, NU * 0.02 / 200.0
    p = _packed(dt)
    got, ref = _both(p, nu, 2, limit, dt)
    for name, a, b in zip(_NAMES, got, ref):
        e = _err(a, b)
        assert e < STEP_TOL, (name, e)
    for i, out in enumerate(("s1", "qdp")):
        base = p["t"][2 + i]
        blocks = zip(got[i].split(NLEV), np.split(ref[i], len(base) // NLEV),
                     base.split(NLEV))
        for j, (a, b, x0) in enumerate(blocks):
            moved = float((a - x0).abs().max()) / float(x0.abs().max())
            assert moved > 2e-4, (out, j, moved)
            e = _err(a - x0, b - x0.numpy())
            assert e < INC_TOL, (out, j, e)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_torch_prim_step_packed_matches_field_form(dtype):
    """The packed f32 step against the port's field form prim_run_step run
    in f32 and in f64 on the same continuous start, at JAX's 5e-4 (rtol and
    atol), with the nu of that test and with one that acts."""
    dt = 0.02
    p = _packed(dt)
    st, dv, g, hv = p["problem"]
    cfg, jcs = p["cfg"], p["jcs"]
    tscal, meta, ts0, tq0, tpec, tacc, dvv = p["t"]
    for nu in (2.5e-4, NU):
        got = prim_step_packed_t4(tscal, meta, ts0, tq0, tpec,
                                  *[a.clone() for a in tacc], dvv, p["plan"],
                                  _T(p["rsp"]), nu, NLEV, qsplit=2, dt=dt)
        cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
        ts, td, tg, th, tcfg = _torch_side(cfg, cast(st), cast(dv), cast(g),
                                           hv.astype(dtype))
        rs, rd, rc = prim_run_step(ts, td, tg, th, tcfg, jcs.gdof, jcs.ndof,
                                   nu=nu, qsplit=2, device="cpu")
        for i, name in enumerate(("u", "v", "t", "dp3d")):
            np.testing.assert_allclose(
                got[0][i * NLEV:(i + 1) * NLEV].numpy(),
                pack_field_t(getattr(rs, name)[tcfg.np1]).numpy(),
                rtol=FIELD_TOL, atol=FIELD_TOL, err_msg=name)
        np.testing.assert_allclose(
            got[1].numpy(),
            pack_qdp_t(rs, dataclasses.replace(tcfg, qn0=1 - tcfg.qn0)).numpy(),
            rtol=FIELD_TOL, atol=FIELD_TOL, err_msg="qdp")
        np.testing.assert_allclose(got[2].numpy(), pack_field_t(rd.phi).numpy(),
                                   rtol=FIELD_TOL, atol=FIELD_TOL)


def test_torch_prim_step_rejects_bad_rows():
    p = _packed(0.02)
    tscal, meta, ts0, tq0, tpec, tacc, dvv = p["t"]
    with pytest.raises(ValueError, match="prim step"):
        prim_step_packed_t4(tscal, meta, ts0, tq0[:6], tpec, *tacc, dvv,
                            p["plan"], _T(p["rsp"]), 0.0, NLEV, dt=0.02)
    with pytest.raises(ValueError, match="prim step"):
        prim_step_packed_t4(tscal, meta, ts0[:12], tq0, tpec, *tacc, dvv,
                            p["plan"], _T(p["rsp"]), 0.0, NLEV, dt=0.02)


def test_torch_prim_t_full_state_wrapper():
    """prim_t = pack, packed step, unpack: np1 and qdp[1 - qn0] hold the
    packed step's outputs bit for bit, every other level is untouched, the
    cfg comes back rotated with qn0 flipped, and a second call chains."""
    dt = 0.02
    p = _packed(dt)
    st, dv, g, hv = p["problem"]
    cfg = p["cfg"]
    ts, td, tg, th, tcfg = _torch_side(cfg, st, dv, g, hv)
    s, d, c = prim_t(ts, td, tg, th, p["plan"], tcfg, nu=NU, qsplit=2,
                     device="cpu")
    pk = prim_pack_t(ts, td, tg, th, tcfg, dt)
    assert torch.equal(pk["s0"], p["t"][2]) and torch.equal(pk["qdp"],
                                                            p["t"][3])
    s1, q1, phi, *acc = prim_step_packed_t4_plain(
        pk["scal"], pk["meta"], pk["s0"], pk["qdp"], pk["pecnd"], *pk["acc"],
        pk["dvv"], p["plan"], pk["rsp"], NU, NLEV, qsplit=2, dt=dt)
    for i, name in enumerate(("u", "v", "t", "dp3d")):
        x = getattr(s, name)
        assert torch.equal(pack_field_t(x[tcfg.np1]),
                           s1[i * NLEV:(i + 1) * NLEV])
        for lev in (tcfg.n0, tcfg.nm1):
            assert torch.equal(x[lev], getattr(ts, name)[lev])
    assert torch.equal(pack_qdp_t(s, c), q1)         # c.qn0 is the new level
    assert torch.equal(s.qdp[tcfg.qn0], ts.qdp[tcfg.qn0])
    assert torch.equal(pack_field_t(d.phi), phi)
    assert torch.equal(pack_field_t(d.omega_p), acc[2])
    assert (c.n0, c.np1, c.nm1, c.qn0) == (tcfg.np1, tcfg.nm1, tcfg.n0,
                                           1 - tcfg.qn0)
    s2, d2, c2 = prim_t(s, d, tg, th, p["plan"], c, nu=NU, qsplit=2,
                        device="cpu")
    assert c2.qn0 == tcfg.qn0 and bool(torch.isfinite(s2.qdp).all())
    assert not torch.equal(s2.qdp[c2.qn0], s.qdp[c2.qn0])
    # unpack inverts pack
    s3, d3 = prim_unpack_t(ts, td, tcfg, pk["s0"], pk["qdp"], phi, acc)
    assert torch.equal(s3.u[tcfg.np1], ts.u[tcfg.n0])
    assert torch.equal(s3.qdp[1 - tcfg.qn0], ts.qdp[tcfg.qn0])


@pytest.mark.parametrize("limit", [False, True])
def test_torch_bench_prim_rotation(limit):
    """The bench's --prim mode on the CPU at ne 2: s_np1 becomes the next
    s0, qdp' the next qdp, the accumulators run on; equal bit for bit to
    explicit steps; the projected tracers start continuous in [0, 1] and
    stay continuous, with the limiter non-negative too."""
    nlev, dt, nu, qsize = 4, 0.05, 1e20, 3
    const, s0, qdp, acc, plan, rsp = bench.make_prim_problem(2, nlev, "cpu",
                                                             dt, qsize)
    scal, meta, pecnd, dvv = const
    assert tuple(qdp.shape) == (qsize * nlev, s0.shape[1])
    assert 0.0 <= float(qdp.min()) and float(qdp.max()) <= 1.0
    from tinman_sandbox_tpu_torch.dist import build_cubed_sphere

    gdof = build_cubed_sphere(2, dtype=torch.float32, device="cpu").gdof
    assert continuity_error_t(qdp, gdof) == 0.0
    s, q, a = s0, qdp, acc
    for _ in range(2):
        s, q, phi, *a = prim_step_packed_t4_plain(
            scal, meta, s, q, pecnd, *a, dvv, plan, rsp, nu, nlev, qsplit=2,
            limit_tracers=limit, dt=dt)
    keep = (s0.clone(), qdp.clone())
    s2, q2, acc2, phi2 = bench.run_prim(const, s0, qdp,
                                        [x.clone() for x in acc], plan, rsp,
                                        2, nu, dt, 2, limit)
    assert torch.equal(s0, keep[0]) and torch.equal(qdp, keep[1])
    assert torch.equal(s2, s) and torch.equal(q2, q) and torch.equal(phi2, phi)
    for x, y in zip(acc2, a):
        assert torch.equal(x, y)
    assert continuity_error_t(q2, gdof) == 0.0
    if limit:
        assert float(q2.min()) >= 0.0


def test_torch_bench_prim_bytes_and_usage():
    """prim_bytes_per_step adds the tracer stages to the dynamics count, and
    the bench refuses inconsistent flags."""
    ne, nlev, nfix = 30, 72, 2856
    e16 = 6 * ne * ne * 16
    for q, split in ((1, 1), (35, 1), (2, 3)):
        extra = bench.prim_bytes_per_step(ne, nlev, nfix, q, split, True) \
            - bench.dynamics_bytes_per_step(ne, nlev, nfix, True)
        stage = ((2 + 4 * q) * nlev + 9) * e16 + 2 * nfix * q * nlev
        assert extra == split * (3 * stage + 2 * q * nlev * e16) * 4
    for argv in (["--prim"], ["--ne", "2", "--limit"],
                 ["--ne", "2", "--qsize", "2"],
                 ["--ne", "2", "--prim", "--rk"],
                 ["--ne", "2", "--prim", "--qsize", "0"]):
        with pytest.raises(SystemExit):
            bench.main(argv)
