"""The port's band-sharded full model step (``dist/prim_banded.py``) and
the multi-device dry run against the JAX package's on the same numpy inputs:
``prim_step_banded_t4`` (ne 4, m 2, 4 shards, qsize 2) against JAX's on its
8-device CPU mesh (Pallas kernels in interpret mode); each banded step
(SSPRK3, hyperviscosity in place and not, tracers, the full step, overlap off
and on) bit for bit the port's single-device step and its plain twin, at
decompositions with one and several chunks a shard and with a middle band;
``multichip.dryrun_multichip`` on the CPU, every tier.

Tolerances: 2e-5 scaled per field against JAX (the STEP_TOL of
tests/test_torch_rk.py); the single-device step, bit for bit; continuity of
the state and the tracers exactly 0. Scales as tests/test_torch_prim.py
states them: on the ne 4 sphere grad^4 is ~1e-20 of a field, so nu = 1e21
makes the hyperviscosity act at dt = 0.02, and a step of dt = 200 (nu 1e17,
the same nu*dt) moves the tracers enough for f32 to hold their increment."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.dss import dss_project as j_dss_project
from tinman_sandbox_tpu.dist.prim_banded import (
    prim_step_banded_t4 as j_prim_banded,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_lanes_2f
from tinman_sandbox_tpu.kernels.caar_pallas_t import _scalars as j_scalars
from tinman_sandbox_tpu.kernels.caar_pallas_t import pack_problem_t as j_pack
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field
from tinman_sandbox_tpu_torch.convert import plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    LocalMesh,
    apply_hypervis_packed_t,
    continuity_error_t,
    hypervis_banded_t,
    hypervis_banded_t_plain,
    prim_step_banded_t4,
    prim_step_banded_t4_plain,
    prim_step_packed_t4,
    shard_packed_t4,
    ssprk3_banded_t4,
    ssprk3_banded_t4_plain,
    ssprk3_packed_t4,
    ssprk3_tracer_packed_t,
    tracer_banded_t,
    tracer_banded_t_plain,
    unshard_packed_t4,
)
from tinman_sandbox_tpu_torch.multichip import dryrun_multichip

torch.set_num_threads(2)
STEP_TOL = 2e-5
NLEV = 4
QSIZE = 2


def _T(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _problem(ne, seed, dt):
    """A packed f32 prim problem for both packages: random state with the
    n0 level projected, QSIZE projected tracers in [0, 1], random
    accumulators and pecnd, dt in scal, the two-float rspheremp."""
    jcs = j_build(ne)
    jp = j_plan(jcs.gdof, ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=NLEV, elem_block=8)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    gdof = jnp.asarray(jcs.gdof)

    def proj(x):
        return np.asarray(j_dss_project(jnp.asarray(x), gdof, jcs.ndof,
                                        g.spheremp, g.rspheremp), np.float32)

    def proj_n0(x):
        x = np.array(x)
        x[cfg.n0] = proj(x[cfg.n0])
        return x

    st = dataclasses.replace(st, u=proj_n0(st.u), v=proj_n0(st.v),
                             t=proj_n0(st.t), dp3d=proj_n0(st.dp3d))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 1)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(np.float32)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    p = j_pack(st, dv, g, hv, cfg)
    s0 = np.concatenate([np.asarray(p[key]) for key in ("u0", "v0", "t0",
                                                        "dp0")])
    q = rng.uniform(0, 1, (QSIZE,) + st.u.shape[1:]).astype(np.float32)
    qdp = np.concatenate([np.asarray(j_pack_field(jnp.asarray(proj(x))))
                          for x in q])
    scal = np.asarray(j_scalars(np.float32(dt), np.float32(1.0), hv))
    acc = tuple(np.asarray(p[key]) for key in ("vn0u", "vn0v", "omg"))
    consts = tuple(p[key] for key in ("dxbt", "dybt", "ainct", "astrt",
                                      "bstrt", "meta"))
    rsp = np.ascontiguousarray(j_rsp_lanes_2f(
        np.asarray(g.spheremp, np.float32), jcs.gdof, jcs.ndof))
    return dict(
        j=(scal, consts, s0, qdp, np.asarray(p["pecnd"]), acc),
        t=(_T(scal), _T(p["meta"]), _T(s0), _T(qdp), _T(p["pecnd"]),
           tuple(_T(a) for a in acc), _T(np.asarray(g.dvv, np.float32))),
        jp=jp, plan=plan_from_fields(jp.ne, jp.edges, jp.corner_rows),
        rsp=_T(rsp), jcs=jcs)


def _sharded(mesh, pr):
    scal, meta, s0, qdp, pecnd, acc, dvv = pr["t"]
    sh = shard_packed_t4(mesh, meta, s0, qdp, pecnd, *acc, pr["rsp"])
    return scal, sh[:4], [[a.clone() for a in x] for x in sh[4:7]], dvv, \
        sh[7]


def test_torch_prim_banded_matches_jax():
    """``prim_step_banded_t4`` (ne 4, m 2, LocalMesh(4), qsize 2, nu 1e21)
    against JAX's on its CPU mesh at 2e-5 per field and for the tracers;
    bit for bit the port's single-device step; continuity 0."""
    dt, nu = 0.02, 1e21
    pr = _problem(4, seed=61, dt=dt)
    scal, consts, s0, qdp, pecnd, acc = pr["j"]
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("e",))
    with jmesh:
        want = j_prim_banded(scal, *consts, s0, qdp, pecnd, *acc, pr["jp"],
                             jnp.asarray(pr["rsp"].numpy()), jmesh, 2, nu,
                             eb=8, nlev=NLEV, interpret=True)
    mesh = LocalMesh(4, "cpu")
    tscal, (meta, ts0, tq, tpec), tacc, dvv, rsp = _sharded(mesh, pr)
    got = prim_step_banded_t4(tscal, meta, ts0, tq, tpec, *tacc, dvv,
                              pr["plan"], rsp, mesh, 2, nu, NLEV, dt=dt)
    got = [unshard_packed_t4(mesh, g) for g in got]
    names = ("s1", "qdp", "phi", "vn0u", "vn0v", "omg")
    errs = {n: _err(a, b) for n, a, b in zip(names, got, want)}
    assert max(errs.values()) < STEP_TOL, errs
    s, meta1, s01, q1, pec1, acc1, dvv1 = pr["t"]
    single = prim_step_packed_t4(s, meta1, s01, q1, pec1,
                                 *(a.clone() for a in acc1), dvv1,
                                 pr["plan"], pr["rsp"], nu, NLEV, dt=dt)
    for a, b in zip(got, single):
        assert torch.equal(a, b)
    for x in got[:2]:
        assert continuity_error_t(x, pr["jcs"].gdof) == 0.0


@pytest.mark.parametrize("ne,m,N", [(4, 2, 4), (6, 3, 18), (8, 4, 3)])
def test_torch_prim_banded_steps_equal_single_device(ne, m, N):
    """SSPRK3, hyperviscosity (a [3*nlev] stack, and a [4*nlev] state
    updated in place), tracers and the full step (qsplit 2), each overlap
    off and on, bit for bit the single-device steps and the plain twins;
    continuity 0; at dt = 200 so the tracer increment shows in f32."""
    dt, nu = 200.0, 1e17 * (ne / 4.0) ** -4
    pr = _problem(ne, seed=70 + N, dt=dt)
    scal, meta, s0, qdp, pecnd, acc, dvv = pr["t"]
    plan, rsp, gdof = pr["plan"], pr["rsp"], pr["jcs"].gdof
    mesh = LocalMesh(N, "cpu")
    _, (bm, bs0, bq, bpec), _, _, brsp = _sharded(mesh, pr)
    un = lambda xs: unshard_packed_t4(mesh, xs)
    sacc = lambda: [[a.clone() for a in x] for x in shard_packed_t4(
        mesh, *acc)]
    want_rk = ssprk3_packed_t4(scal, meta, s0, qdp[:NLEV], pecnd,
                               *(a.clone() for a in acc), dvv, plan, rsp)
    s1 = want_rk[0]
    want_hv3 = apply_hypervis_packed_t(dvv, meta, s1[:3 * NLEV].contiguous(),
                                       plan, rsp, nu, dt, NLEV)
    want_hv4 = apply_hypervis_packed_t(dvv, meta, s1.clone(), plan, rsp, nu,
                                       dt, NLEV)
    want_tr = ssprk3_tracer_packed_t(dvv, meta, s1, s1, qdp, plan, rsp, dt,
                                     NLEV, wind_rows=(0, 1))
    want_prim = prim_step_packed_t4(scal, meta, s0, qdp, pecnd,
                                    *(a.clone() for a in acc), dvv, plan, rsp,
                                    nu, NLEV, qsplit=2, dt=dt)
    assert float((want_tr - qdp).abs().max()) > 1e-3 * float(qdp.max())
    (bs1,) = shard_packed_t4(mesh, s1)
    for overlap in (False, True):
        kw = dict(overlap=overlap)
        for fn in (ssprk3_banded_t4, ssprk3_banded_t4_plain):
            got = fn(scal, bm, bs0, [q[:NLEV] for q in bq], bpec, *sacc(),
                     dvv, plan, brsp, mesh, m, **kw)
            assert all(torch.equal(un(a), b) for a, b in zip(got, want_rk))
        for fn in (hypervis_banded_t, hypervis_banded_t_plain):
            got3 = fn(dvv, bm, [x[:3 * NLEV].contiguous() for x in bs1], plan,
                      brsp, mesh, m, nu, dt, NLEV, **kw)
            assert torch.equal(un(got3), want_hv3)
            x4 = [x.clone() for x in bs1]
            got4 = fn(dvv, bm, x4, plan, brsp, mesh, m, nu, dt, NLEV, **kw)
            assert torch.equal(un(got4), want_hv4)
            if fn is hypervis_banded_t:
                assert all(a is b for a, b in zip(got4, x4))
        for fn in (tracer_banded_t, tracer_banded_t_plain):
            got = fn(dvv, bm, bs1, bs1, bq, plan, brsp, mesh, m, dt, NLEV,
                     wind_rows=(0, 1), **kw)
            assert torch.equal(un(got), want_tr)
        for fn in (prim_step_banded_t4, prim_step_banded_t4_plain):
            got = fn(scal, bm, bs0, bq, bpec, *sacc(), dvv, plan, brsp, mesh,
                     m, nu, NLEV, qsplit=2, dt=dt, **kw)
            assert all(torch.equal(un(a), b) for a, b in zip(got, want_prim))
    for x in (want_rk[0], want_hv4, want_tr, *want_prim[:2]):
        assert continuity_error_t(x, gdof) == 0.0


def test_torch_prim_banded_rejects_bad_rows():
    pr = _problem(4, seed=3, dt=0.02)
    mesh = LocalMesh(4, "cpu")
    scal, (bm, bs0, bq, bpec), bacc, dvv, brsp = _sharded(mesh, pr)
    with pytest.raises(ValueError, match="rows"):
        prim_step_banded_t4(scal, bm, [x[:12] for x in bs0], bq, bpec, *bacc,
                            dvv, pr["plan"], brsp, mesh, 2, 0.0, NLEV)
    with pytest.raises(ValueError, match="rows"):
        hypervis_banded_t(dvv, bm, [x[:5] for x in bs0], pr["plan"], brsp,
                          mesh, 2, 1.0, 1.0, NLEV)


@pytest.mark.parametrize("n", [4, 8, 12])
def test_torch_dryrun_multichip_on_cpu(n):
    """The port's dry run on the CPU runs every tier: 1-4 (the
    element-sharded psum, ppermute, segment-sum and overlap steps) within
    1e-4 of the single-device step and of each other, 5-7 bit for bit the
    single-device steps, 8 (banded at nlev 72) within 1e-4 of the
    segment-sum step; a subset runs alone."""
    ran = dryrun_multichip(n, device="cpu")
    assert set(ran) == {1, 2, 3, 4, 5, 6, 7, 8}
    assert set(dryrun_multichip(n, device="cpu", tiers=(2, 8))) == {2, 8}
