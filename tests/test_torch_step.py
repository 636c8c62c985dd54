"""The port's assembled step (CAAR + structured DSS on the cubed sphere)
against the JAX package's on the same numpy inputs, ne = 2 and 3 at a few
levels, the JAX Pallas kernels in interpret mode. Errors are scaled
max-abs per output field, |a - b| / max|b|.

Tolerances: 3e-6 for one f32 step (the CAAR tendencies are summed in
another order than the Pallas kernel's matrix-unit contractions, as in
tests/test_torch_caar.py), 2e-5 after three chained steps, 1e-12 for the
f64 oracle path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist import caar_dss_step as j_caar_dss_step
from tinman_sandbox_tpu.dist.step_pallas import (
    caar_dss_structured_packed_t4 as j_step_t4,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_lanes_2f
from tinman_sandbox_tpu.kernels.caar_pallas_t import _scalars as j_scalars
from tinman_sandbox_tpu.kernels.caar_pallas_t import pack_problem_t as j_pack
from tinman_sandbox_tpu_torch import Config, bench
from tinman_sandbox_tpu_torch.convert import (
    cubed_sphere_from_numpy,
    from_numpy,
    plan_from_fields,
)
from tinman_sandbox_tpu_torch.dist import (
    build_cubed_sphere,
    caar_dss_structured_packed_t,
    caar_dss_structured_packed_t4,
    caar_dss_structured_packed_t4_plain,
    caar_dss_t,
    continuity_error_t,
    make_structured_plan,
)
from tinman_sandbox_tpu_torch.kernels.caar_t import caar_packed_t, caar_t4_cuda
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_extract_cuda,
    dss_fixup_cuda,
    dss_sweep_cuda,
    fix_tables,
)

torch.set_num_threads(2)
WRAPPERS = (caar_t4_cuda, dss_extract_cuda, dss_fixup_cuda, dss_sweep_cuda)


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _jax_problem(ne, nlev, seed, dtype=np.float32, eb=8):
    """A JAX problem on the cubed sphere: random state, random accumulators
    and pecnd (``seed + 1``), the grid's geometry. Returns (jcs, cfg, st,
    dv, g, hv)."""
    jcs = j_build(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=nlev, elem_block=eb)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=seed))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 1)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(dtype)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    return (jcs, cfg, st, dv, cast(jcs.geometry),
            jt.analytic_hvcoord(cfg).astype(dtype))


def _stacked(ne, nlev, seed, eb=8):
    """The stacked operands for both packages: (jax_args, port_args, plan,
    jplan, rsp) with args = (scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
    omg) and the port's plan handed over from the JAX plan."""
    jcs, cfg, st, dv, g, hv = _jax_problem(ne, nlev, seed, eb=eb)
    p = j_pack(st, dv, g, hv, cfg)
    cat = lambda keys: np.concatenate([np.asarray(p[k]) for k in keys])
    jargs = (np.asarray(j_scalars(np.float32(0.1), np.float32(1.0), hv)),
             np.asarray(p["meta"]), cat(("u0", "v0", "t0", "dp0")),
             cat(("um1", "vm1", "tm1", "dpm1")),
             *(np.asarray(p[k]) for k in ("qdp", "pecnd", "vn0u", "vn0v",
                                          "omg")))
    jp = j_plan(jcs.gdof, ne)
    rsp = j_rsp_lanes_2f(np.asarray(g.spheremp, np.float32), jcs.gdof,
                         jcs.ndof)
    targs = tuple(torch.from_numpy(np.array(a)) for a in jargs)
    dvv = torch.from_numpy(np.asarray(g.dvv, np.float32))
    plan = plan_from_fields(jp.ne, jp.edges, jp.corner_rows)
    pxs = tuple(p[k] for k in ("dxbt", "dybt", "ainct", "astrt", "bstrt"))
    return (jargs, pxs), (targs, dvv), plan, jp, rsp, jcs


def _run_jax_t4(jargs, pxs, jp, rsp, nlev, eb, lg):
    scal, meta, s0, sm1, qdp, pecnd, *acc = jargs
    return j_step_t4(scal, *pxs, meta, s0, sm1, qdp, pecnd, *acc, jp,
                     jnp.asarray(rsp), eb=eb, nlev=nlev, lg=lg,
                     interpret=True)


def _field_errs(got, ref, nlev):
    names = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg")
    pairs = list(zip(got[0].split(nlev), np.split(np.asarray(ref[0]), 4)))
    pairs += list(zip(got[1:], ref[1:]))
    return {n: _err(a, b) for n, (a, b) in zip(names, pairs)}


@pytest.mark.parametrize("ne,eb,lg", [(2, 8, 0), (2, 8, 3), (3, 6, 0)])
def test_torch_assembled_t4_matches_jax(ne, eb, lg):
    """The stacked assembled step (the wrappers on CPU tensors, that is the
    plain versions) against JAX's: lg=0 runs the producer-fused compact
    path (ne=2, eb=8), lg=3 the lane-grouped kernel, ne=3 the unfused
    fallback of odd ne. The port has one path for all three."""
    nlev = 6
    (jargs, pxs), (targs, dvv), plan, jp, rsp, jcs = _stacked(
        ne, nlev, seed=20 + ne + lg, eb=eb)
    ref = _run_jax_t4(jargs, pxs, jp, rsp, nlev, eb, lg)
    R = torch.from_numpy(rsp)
    counts = [w.launches for w in WRAPPERS]
    acc = [a.clone() for a in targs[6:]]
    got = caar_dss_structured_packed_t4(*targs[:6], *acc, dvv, plan, R)
    assert [w.launches for w in WRAPPERS] == counts
    assert all(g is a for g, a in zip(got[2:], acc))      # in place
    errs = _field_errs(got, ref, nlev)
    assert max(errs.values()) < 3e-6, errs
    plain = caar_dss_structured_packed_t4_plain(*targs, dvv, plan, R)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert continuity_error_t(got[0], jcs.gdof) == 0.0


def test_torch_caar_dss_t_f64_matches_caar_dss_step():
    """The full-state assembled step in f64 (pack, CAAR, extract + fixup +
    sweep per field, unpack) against the JAX package's array-form
    caar_dss_step (caar_xla + segment-sum DSS) at 1e-12."""
    jcs, cfg, st, dv, g, hv = _jax_problem(2, 5, seed=3, dtype=np.float64)
    js, jd = j_caar_dss_step(st, dv, g, hv, jnp.asarray(jcs.gdof), jcs.ndof,
                             cfg, 0.1, 0.5)
    ts, td, tg, th = from_numpy(_np(st), _np(dv), _np(g), _np(hv),
                                device="cpu")
    plan = make_structured_plan(jcs.gdof, 2)
    tcfg = Config(nelem=cfg.nelem, nlev=cfg.nlev)
    s, d = caar_dss_t(ts, td, tg, th, plan, tcfg, 0.1, 0.5, device="cpu")
    for name in ("u", "v", "t", "dp3d"):
        e = _err(getattr(s, name)[cfg.np1], np.asarray(getattr(js, name))[
            cfg.np1])
        assert e < 1e-12, (name, e)
    for name in ("vn0_u", "vn0_v", "phi", "omega_p"):
        e = _err(getattr(d, name), getattr(jd, name))
        assert e < 1e-12, (name, e)


@pytest.mark.parametrize("two_float", [False, True])
def test_torch_unstacked_assembled_equals_stacked(two_float):
    """caar_dss_structured_packed_t (the CAAR step, then a whole DSS for each
    field) equals the stacked slab-fused step bit for bit, and the CAAR
    slab of both forms is s1 at the fix lanes."""
    nlev = 4
    _, (targs, dvv), plan, _, rsp, _ = _stacked(3, nlev, seed=5, eb=6)
    R = torch.from_numpy(rsp if two_float else rsp[:1] + rsp[1:])
    st = caar_dss_structured_packed_t4(*targs[:6],
                                       *(a.clone() for a in targs[6:]),
                                       dvv, plan, R)
    scal, meta, s0, sm1, qdp, pecnd, *acc = targs
    un = caar_dss_structured_packed_t(
        scal, meta, *s0.split(nlev), *sm1.split(nlev), qdp, pecnd,
        *(a.clone() for a in acc), dvv, plan, R)
    assert torch.equal(torch.cat(un[:4]), st[0])
    for a, b in zip(un[4:], st[1:]):
        assert torch.equal(a, b)
    # the slab option of both CAAR entries
    fix = fix_tables(plan, "cpu")
    o4 = caar_t4_cuda(*targs[:6], *(a.clone() for a in acc), dvv, fix=fix)
    lanes = fix.read_lanes.long()
    assert torch.equal(o4[-1], o4[0][:, lanes].T)
    ou = caar_packed_t(scal, meta, *s0.split(nlev), *sm1.split(nlev), qdp,
                       pecnd, *(a.clone() for a in acc), dvv, fix=fix)
    assert torch.equal(ou[-1], o4[-1])


def test_torch_assembled_chain_matches_jax_chain():
    """Three chained assembled steps, each step's assembled s1 the next n0
    and the old n0 the next nm1 (the root bench's rotation), accumulators
    chained: the port's bench loop against the same loop on JAX's step."""
    nlev, nsteps = 6, 3
    (jargs, pxs), (targs, dvv), plan, jp, rsp, jcs = _stacked(
        2, nlev, seed=40)
    scal, meta, s0, sm1, qdp, pecnd, *acc = jargs
    for _ in range(nsteps):
        s1, phi, *acc = _run_jax_t4((scal, meta, s0, sm1, qdp, pecnd, *acc),
                                    pxs, jp, rsp, nlev, 8, 0)
        s0, sm1 = s1, s0
    tscal, tmeta, ts0, tsm1, tqdp, tpec, *tacc = targs
    (n0, nm1), tacc, tphi = bench.run_assembled(
        (tscal, tmeta, tqdp, tpec, dvv), (ts0, tsm1), tacc, plan,
        torch.from_numpy(rsp), nsteps)
    for name, a, b in (("n0", n0, s0), ("nm1", nm1, sm1), ("phi", tphi, phi),
                       *zip(("vn0u", "vn0v", "omg"), tacc, acc)):
        e = _err(a, b)
        assert e < 2e-5, (name, e)
    assert continuity_error_t(n0, jcs.gdof) == 0.0


def test_torch_assembled_on_handed_over_grid_equals_own_grid():
    """The convert hand-over: a JAX cubed sphere and plan passed as numpy
    give the port's assembled step the same bits as the port's own grid."""
    jcs = j_build(2)
    jp = j_plan(jcs.gdof, 2)
    mesh = {f.name: getattr(jcs, f.name) for f in dataclasses.fields(jcs)
            if f.name != "geometry"}
    handed = cubed_sphere_from_numpy(mesh, _np(jcs.geometry), device="cpu")
    own = build_cubed_sphere(2, device="cpu")
    cfg = Config(nelem=own.nelem, nlev=4)
    st = jt.random_state(jt.Config(nelem=own.nelem, nlev=4), seed=9)
    dv = jt.zero_derived(jt.Config(nelem=own.nelem, nlev=4))
    hv = jt.analytic_hvcoord(jt.Config(nelem=own.nelem, nlev=4))
    ts, td, _, th = from_numpy(_np(st), _np(dv), _np(jcs.geometry), _np(hv),
                               device="cpu")
    outs = [caar_dss_t(ts, td, cs.geometry, th, plan, cfg, 0.1, 1.0,
                       device="cpu")
            for cs, plan in ((handed, plan_from_fields(jp.ne, jp.edges,
                                                       jp.corner_rows)),
                             (own, make_structured_plan(own.gdof, 2)))]
    for name in ("u", "v", "t", "dp3d"):
        assert torch.equal(getattr(outs[0][0], name),
                           getattr(outs[1][0], name)), name


def test_torch_bench_assembled_rotates_levels():
    """The bench's --ne mode: two chained steps equal two explicit steps
    with the rotation n0 <- assembled s1, nm1 <- old n0; the byte count is
    the documented one."""
    const, (s0, sm1), acc, plan, rsp = bench.make_assembled_problem(
        2, 4, "cpu")
    scal, meta, qdp, pecnd, dvv = const
    step = caar_dss_structured_packed_t4_plain
    a1 = step(scal, meta, s0, sm1, qdp, pecnd, *acc, dvv, plan, rsp)
    a2 = step(scal, meta, a1[0], s0, qdp, pecnd, *a1[2:], dvv, plan, rsp)
    (n0, nm1), acc2, phi = bench.run_assembled(
        const, (s0, sm1), [a.clone() for a in acc], plan, rsp, 2)
    assert torch.equal(n0, a2[0]) and torch.equal(nm1, a1[0])
    assert torch.equal(phi, a2[1])
    for a, b in zip(acc2, a2[2:]):
        assert torch.equal(a, b)
    assert rsp.shape == (2, 384)
    assert bench.assembled_bytes_per_step(30, 72, 2856) == \
        (29 * 72 + 2) * 86400 * 4 + 2 * 2856 * 288 * 4
