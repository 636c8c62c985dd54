"""The port's tracer transport against the JAX package's on the same numpy
inputs: the compensated sum and the field-form limiter, the field-form Euler
and SSPRK3 tracer steps in f64, the two tracer kernels' plain versions
against the Pallas kernels in interpret mode, and the packed SSPRK3 tracer
step as a whole, at ne = 2, 3, 4 and a few levels.
Errors are scaled max-abs, |a - b| / max|b|, unless said otherwise.

Tolerances: 1e-12 for the f64 field forms (same math; only einsum and sum
orders differ); 3e-6 (scaled by max|b| + 1, the limit of
tests/test_tracer_pallas.py) for one f32 kernel call, whose contractions
are summed in another order than the Pallas kernel's matrix products; 2e-5
for the packed f32 step against JAX's, on the field and on the increment
q' - q; 3e-4 unlimited and 2e-4 limited (rtol and atol, the limits of
tests/test_structured_dss.py) against the field form; 2e-6 relative for the
global tracer mass; 4e-6 of sum|w*y| for the limiter's conservation per
element and 1e-6 of max|q| for its bounds."""
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
    ssprk3_tracer_packed_t as j_tracer_packed,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_lanes_2f
from tinman_sandbox_tpu.kernels.dss_pallas import cext_tables
from tinman_sandbox_tpu.kernels.layout import (
    block_derivative_ops,
    pack_field_t as j_pack_field,
    pack_meta_t as j_pack_meta,
)
from tinman_sandbox_tpu.kernels.tracer_pallas_t import (
    tracer_euler_pallas_packed_t,
    tracer_euler_pallas_packed_t_ext,
    tracer_limit_pallas_packed_t_ext,
)
from tinman_sandbox_tpu.ops.limiter import element_bounds as j_element_bounds
from tinman_sandbox_tpu.ops.limiter import limit_tracer as j_limit_tracer
from tinman_sandbox_tpu.ops.remap import comp_sum as j_comp_sum
from tinman_sandbox_tpu.timeloop.tracer import euler_step as j_euler_step
from tinman_sandbox_tpu.timeloop.tracer import (
    ssprk3_tracer_step as j_ssprk3_tracer_step,
)
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.convert import (
    from_numpy,
    pack_qdp_t,
    plan_from_fields,
    unpack_qdp_t,
)
from tinman_sandbox_tpu_torch.dist import (
    continuity_error_t,
    ssprk3_tracer_packed_t,
    ssprk3_tracer_packed_t_plain,
)
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_fixup_cuda,
    dss_sweep_cuda,
    fix_tables,
)
from tinman_sandbox_tpu_torch.kernels.tracer_t import (
    tracer_euler_cuda,
    tracer_euler_plain,
    tracer_limit_cuda,
    tracer_limit_plain,
)
from tinman_sandbox_tpu_torch.ops import comp_sum, element_bounds, limit_tracer
from tinman_sandbox_tpu_torch.timeloop import (
    advance_qdp,
    euler_step,
    ssprk3_tracer_step,
)

torch.set_num_threads(2)
F64_TOL = 1e-12
KERNEL_TOL = 3e-6
STEP_TOL = 2e-5
# a step that moves qdp by ~1e-2 of itself, so that f32 resolves the increment
# q' - q to the step tolerance (at dt = 0.02 the increment is below one ulp)
STEP_DT = 1.0e4
MASS_TOL = 2e-6
CONSERVE_TOL = 4e-6
BOUNDS_TOL = 1e-6


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _kerr(a, b):
    """The f32 kernel measure of tests/test_tracer_pallas.py."""
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1.0)


def _T(a):
    return torch.from_numpy(np.array(a))


def _problem(ne, nlev, qsize, seed, dtype=np.float32, eb=8):
    """A JAX tracer problem on the cubed sphere: random winds, a random qdp
    in [0, 1] projected onto the continuous space. Returns (jcs, cfg, st, g,
    qdp, vu, vv), the last three numpy."""
    jcs = j_build(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=nlev, qsize=qsize, elem_block=eb)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    qdp = np.asarray(j_dss_project(
        jnp.asarray(st.qdp[0]), jnp.asarray(jcs.gdof), jcs.ndof, g.spheremp,
        g.rspheremp), dtype)
    return jcs, cfg, st, g, qdp, np.asarray(st.u[0]), np.asarray(st.v[0])


def _packed(ne, nlev, qsize, seed, eb=8, two_float=False):
    """Packed f32 operands for both packages. Returns a dict: the JAX side
    (dxbt, dybt, meta, vu, vv, q) under "j", the port's tensors (meta, vu,
    vv, q, dvv) under "t", both plans, rsp, and the field-form problem."""
    jcs, cfg, st, g, qdp, vu, vv = _problem(ne, nlev, qsize, seed, eb=eb)
    dxb, dyb = block_derivative_ops(eb, g.dvv, np.float32)
    meta = np.asarray(j_pack_meta(g, st.phis, jnp.float32))
    pvu = np.asarray(j_pack_field(jnp.asarray(vu)))
    pvv = np.asarray(j_pack_field(jnp.asarray(vv)))
    q = np.concatenate([np.asarray(j_pack_field(jnp.asarray(qdp[:, i])))
                        for i in range(qsize)])
    jp = j_plan(jcs.gdof, ne)
    if two_float:
        rsp = j_rsp_lanes_2f(np.asarray(g.spheremp, np.float32), jcs.gdof,
                             jcs.ndof)
    else:
        rsp = np.asarray(g.rspheremp, np.float32).reshape(1, -1)
    return dict(
        j=(jnp.asarray(dxb).T, jnp.asarray(dyb).T, jnp.asarray(meta),
           jnp.asarray(pvu), jnp.asarray(pvv), jnp.asarray(q)),
        t=(_T(meta), _T(pvu), _T(pvv), _T(q),
           _T(np.asarray(g.dvv, np.float32))),
        jp=jp, plan=plan_from_fields(jp.ne, jp.edges, jp.corner_rows),
        rsp=np.ascontiguousarray(rsp), jcs=jcs, cfg=cfg, g=g, st=st,
        field=(qdp, vu, vv))


def _scal(dt, ca=0.0, cb=0.0):
    return jnp.asarray([[dt, ca, cb, 0.0]], jnp.float32)


# -- ops: comp_sum and the field-form limiter --------------------------------

@pytest.mark.parametrize("axis", [0, 1, -1])
def test_torch_comp_sum_matches_jax(axis):
    """Neumaier sum in f64 against JAX's at 1e-12, and in f32 closer to the
    f64 sum than the plain sum on a cancelling series."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 9, 16)) * 10.0 ** rng.integers(-6, 6, (7, 9, 16))
    ref = np.asarray(j_comp_sum(jnp.asarray(x), axis))
    got = comp_sum(_T(x), axis)
    assert got.shape == ref.shape
    assert _err(got, ref) < F64_TOL
    x32 = _T(x.astype(np.float32))
    exact = x.astype(np.float32).astype(np.float64).sum(axis)
    assert np.abs(comp_sum(x32, axis).double().numpy() - exact).max() <= \
        np.abs(x32.sum(axis).double().numpy() - exact).max()


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_torch_limit_tracer_matches_jax(iters):
    """element_bounds and limit_tracer in f64 against JAX's at 1e-12, with
    prescribed bounds and with the bounds of another field."""
    rng = np.random.default_rng(2)
    q = rng.uniform(-0.2, 1.3, (6, 3, 4, 4))
    w = rng.uniform(0.5, 2.0, (6, 1, 4, 4))
    q_in = rng.uniform(0.0, 1.0, (6, 3, 4, 4))
    jmin, jmax = j_element_bounds(jnp.asarray(q_in))
    tmin, tmax = element_bounds(_T(q_in))
    assert np.array_equal(tmin.numpy(), np.asarray(jmin))
    assert np.array_equal(tmax.numpy(), np.asarray(jmax))
    ref = np.asarray(j_limit_tracer(jnp.asarray(q), jnp.asarray(w), jmin,
                                    jmax, iters=iters))
    got = limit_tracer(_T(q), _T(w), tmin, tmax, iters=iters)
    assert _err(got, ref) < F64_TOL
    zero, one = np.zeros((6, 3, 1, 1)), np.ones((6, 3, 1, 1))
    ref = np.asarray(j_limit_tracer(jnp.asarray(q), jnp.asarray(w),
                                    jnp.asarray(zero), jnp.asarray(one),
                                    iters=iters))
    got = limit_tracer(_T(q), _T(w), _T(zero), _T(one), iters=iters)
    assert _err(got, ref) < F64_TOL


@pytest.mark.parametrize("prop", ["mass", "bounds", "identity", "uniform_f32"])
def test_torch_limit_tracer_properties(prop):
    """The properties tests/test_advection.py holds JAX's limiter to: mass
    conserved per element-level, bounds respected wherever feasible,
    identity inside the bounds, and no NaN on uniform f32 elements."""
    rng = np.random.default_rng(2)
    q = _T(rng.uniform(-0.2, 1.3, (6, 3, 4, 4)))
    w = _T(rng.uniform(0.5, 2.0, (6, 3, 4, 4)))
    qmin, qmax = torch.zeros(6, 3, 1, 1).double(), torch.ones(6, 3, 1, 1).double()
    out = limit_tracer(q, w, qmin, qmax)
    mass = (q * w).sum((-2, -1))
    if prop == "mass":
        np.testing.assert_allclose((out * w).sum((-2, -1)).numpy(),
                                   mass.numpy(), rtol=1e-12)
    elif prop == "bounds":
        feasible = (mass >= 0.0) & (mass <= w.sum((-2, -1)))
        viol = (out - 1.0).clamp(min=0) + (-out).clamp(min=0)
        assert feasible.any()
        assert float(viol.amax((-2, -1))[feasible].max()) < 1e-10
    elif prop == "identity":
        q_ok = _T(rng.uniform(0.2, 0.8, (2, 2, 4, 4)))
        out_ok = limit_tracer(q_ok, w[:2, :2], qmin[:2, :2], qmax[:2, :2])
        np.testing.assert_allclose(out_ok.numpy(), q_ok.numpy(), rtol=1e-12)
    else:
        half = torch.full((4, 2, 1, 1), 0.5)
        out = limit_tracer(torch.full((4, 2, 4, 4), 0.5),
                           torch.ones(4, 2, 4, 4), half, half)
        assert out.dtype == torch.float32
        assert bool(torch.isfinite(out).all())
        np.testing.assert_allclose(out.numpy(), 0.5, rtol=1e-6)


# -- the field-form steps in f64 ---------------------------------------------

@pytest.mark.parametrize("ne,qsize", [(2, 1), (2, 3), (3, 1), (3, 3)])
def test_torch_euler_step_f64_matches_jax(ne, qsize):
    jcs, cfg, st, g, qdp, vu, vv = _problem(ne, 4, qsize, seed=3,
                                            dtype=np.float64)
    dt = 7.5
    ref = np.asarray(j_euler_step(qdp, vu, vv, g, cfg, dt))
    ts, _, tg, _ = from_numpy(_np(st), _np(jt.zero_derived(cfg)), _np(g),
                              _np(jt.analytic_hvcoord(cfg)), device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=cfg.nlev, qsize=qsize)
    got = euler_step(_T(qdp), _T(vu), _T(vv), tg, tcfg, dt)
    assert got.shape == ref.shape
    assert _err(got, ref) < F64_TOL
    assert _err(got - _T(qdp), ref - qdp) < 1e-10         # the increment
    # the full-state form writes the other qdp level and leaves the input
    new = advance_qdp(ts, tg, tcfg, dt)
    want = np.asarray(j_euler_step(st.qdp[0], vu, vv, g, cfg, dt))
    assert _err(new.qdp[1], want) < F64_TOL
    assert torch.equal(new.qdp[0], ts.qdp[0]) and new.qdp is not ts.qdp


@pytest.mark.parametrize("ne,qsize,limit,project", [
    (2, 1, False, True), (2, 3, True, True), (3, 3, False, True),
    (3, 1, True, True), (2, 3, False, False), (2, 1, True, False),
    (2, 3, True, "two_float")])
def test_torch_ssprk3_tracer_step_f64_matches_jax(ne, qsize, limit, project):
    """timeloop.ssprk3_tracer_step in f64 against JAX's: with and without
    the limiter, with and without the dof map, with the two-float
    rspheremp."""
    from tinman_sandbox_tpu.dist.dss import rsp_2f as j_rsp_2f

    jcs, cfg, st, g, qdp, vu, vv = _problem(ne, 3, qsize, seed=4,
                                            dtype=np.float64)
    dt = 100.0          # moves qdp by ~1e-4: the increment is then resolved
    kw, tkw = {}, {}
    if project:
        kw = dict(gdof=jnp.asarray(jcs.gdof), ndof=jcs.ndof)
        tkw = dict(gdof=jcs.gdof, ndof=jcs.ndof)
    if project == "two_float":
        hi, lo = j_rsp_2f(g.spheremp, jcs.gdof, jcs.ndof)
        kw["rsp2"] = (jnp.asarray(hi, jnp.float64), jnp.asarray(lo, jnp.float64))
        tkw["rsp2"] = (_T(hi).double(), _T(lo).double())
    ref = np.asarray(j_ssprk3_tracer_step(
        jnp.asarray(qdp), jnp.asarray(vu), jnp.asarray(vv), g, cfg, dt,
        limit=limit, **kw))
    _, _, tg, _ = from_numpy(_np(st), _np(jt.zero_derived(cfg)), _np(g),
                             _np(jt.analytic_hvcoord(cfg)), device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=cfg.nlev, qsize=qsize)
    tq = _T(qdp)
    got = ssprk3_tracer_step(tq, _T(vu), _T(vv), tg, tcfg, dt, limit=limit,
                             **tkw)
    assert np.array_equal(tq.numpy(), qdp)                  # input untouched
    assert _err(got, ref) < F64_TOL
    assert _err(got - tq, ref - qdp) < 1e-9                 # the increment


# -- the kernels' plain versions against the Pallas kernels ------------------

@pytest.mark.parametrize("qsize,fold_sph,state_winds", [
    (1, True, False), (3, True, False), (3, False, False), (1, False, True),
    (3, True, True)])
def test_torch_tracer_euler_matches_pallas(qsize, fold_sph, state_winds):
    """tracer_euler (the wrapper on CPU tensors, that is the plain version)
    against tracer_euler_pallas_packed_t in interpret mode; the winds
    straight from their own buffers or by row block out of a [4*nlev]
    state."""
    nlev, dt = 4, 7.5
    p = _packed(2, nlev, qsize, seed=17)
    dxbt, dybt, jmeta, jvu, jvv, jq = p["j"]
    meta, vu, vv, q, dvv = p["t"]
    rows = (0, 0)
    if state_winds:
        rng = np.random.default_rng(1)
        pad = rng.standard_normal((2 * nlev, q.shape[1])).astype(np.float32)
        s = np.concatenate([np.asarray(jvu), np.asarray(jvv), pad])
        jvu = jvv = jnp.asarray(s)
        vu = vv = _T(s)
        rows = (0, 1)
    ref = np.asarray(tracer_euler_pallas_packed_t(
        _scal(dt), dxbt, dybt, jmeta, jvu, jvv, jq, eb=8, nlev=nlev,
        fold_sph=fold_sph, wind_rows=rows, interpret=True))
    n0 = tracer_euler_cuda.launches
    got = tracer_euler_cuda(meta, vu, vv, q, dvv, dt, nlev, fold_sph=fold_sph,
                            wind_rows=rows)
    assert tracer_euler_cuda.launches == n0          # no launch on the CPU
    assert got.shape == ref.shape and _kerr(got, ref) < KERNEL_TOL
    for a, b in zip(got.split(nlev), np.split(ref, qsize)):
        assert _kerr(a, b) < KERNEL_TOL                      # every tracer
    # the advective increment alone: a dropped term fails here
    sph = meta[11] if fold_sph else 1.0
    assert _err(got - sph * q, ref - np.asarray(sph * q)) < 1e-5
    assert torch.equal(got, tracer_euler_plain(
        meta, vu, vv, q, dvv, dt, nlev, fold_sph=fold_sph, wind_rows=rows))


@pytest.mark.parametrize("qsize", [1, 3])
def test_torch_tracer_euler_slab_matches_pallas_ext(qsize):
    """With ``fix=``: the field against tracer_euler_pallas_packed_t_ext
    with the compact slab (interpret), and the slab bit for bit the output
    at the fix lanes."""
    nlev, dt = 4, 7.5
    p = _packed(2, nlev, qsize, seed=18)
    dxbt, dybt, jmeta, jvu, jvv, jq = p["j"]
    meta, vu, vv, q, dvv = p["t"]
    sf, nt, cM, cq = cext_tables(p["jp"], q.shape[1] // 128)
    ref, _ = tracer_euler_pallas_packed_t_ext(
        _scal(dt), dxbt, dybt, jmeta, jvu, jvv, jq, jnp.asarray(sf), nt=nt,
        nlev=nlev, cq=jnp.asarray(cq), cM=cM, interpret=True)
    fix = fix_tables(p["plan"], "cpu")
    n0 = tracer_euler_cuda.slab_launches
    got, slab = tracer_euler_cuda(meta, vu, vv, q, dvv, dt, nlev, fix=fix)
    assert tracer_euler_cuda.slab_launches == n0
    assert _kerr(got, np.asarray(ref)) < KERNEL_TOL
    assert tuple(slab.shape) == (fix.nfix, qsize * nlev)
    assert torch.equal(slab, got[:, fix.read_lanes.long()].T)
    assert torch.equal(got, tracer_euler_cuda(meta, vu, vv, q, dvv, dt, nlev))


def _limit_inputs(qsize, seed, push):
    """Packed operands whose advected value leaves the bounds: the input q
    is squeezed toward its element mean, so that ``push`` of the advective
    step sticks out of the narrow bounds in many elements."""
    p = _packed(2, 4, qsize, seed=seed)
    meta, vu, vv, q, dvv = p["t"]
    el = q.reshape(q.shape[0], -1, 16)
    q = (el.mean(2, keepdim=True) + push * (el - el.mean(2, keepdim=True))) \
        .reshape(q.shape).contiguous()
    rng = np.random.default_rng(seed + 1)
    mx = _T(rng.uniform(0, 1, tuple(q.shape)).astype(np.float32))
    return p, q, mx


@pytest.mark.parametrize("qsize,mix,iters", [
    (1, False, 2), (3, False, 2), (3, True, 2), (1, True, 1), (3, False, 1),
    (3, False, 0), (1, True, 0)])
def test_torch_tracer_limit_matches_pallas(qsize, mix, iters):
    """tracer_limit (the wrapper on CPU tensors) against
    tracer_limit_pallas_packed_t_ext in interpret mode, with and without the
    Shu-Osher combination, zero, one and two limiter passes (zero: only the
    final residual pass, which JAX's kernel admits too); slab bit for bit
    the output at the fix lanes."""
    # without the combination only the advective step can leave the bounds:
    # a long step, so that it does
    nlev, dt = 4, (7.5 if mix else 3.0e4)
    p, q, mx = _limit_inputs(qsize, 19, push=0.2)
    dxbt, dybt, jmeta, jvu, jvv, _ = p["j"]
    meta, vu, vv, _, dvv = p["t"]
    ca, cb = np.float32(1.0 / 3.0), np.float32(2.0 / 3.0)
    sf, nt, cM, cq = cext_tables(p["jp"], q.shape[1] // 128)
    ref, _ = tracer_limit_pallas_packed_t_ext(
        _scal(dt, ca, cb), dxbt, dybt, jmeta, jvu, jvv, jnp.asarray(q.numpy()),
        jnp.asarray(mx.numpy()) if mix else None, jnp.asarray(sf), nt=nt,
        nlev=nlev, has_mix=mix, cq=jnp.asarray(cq), cM=cM, iters=iters,
        interpret=True)
    fix = fix_tables(p["plan"], "cpu")
    counts = (tracer_limit_cuda.launches, tracer_limit_cuda.slab_launches)
    tmix = (mx, ca, cb) if mix else None
    got, slab = tracer_limit_cuda(meta, vu, vv, q, dvv, dt, nlev, mix=tmix,
                                  iters=iters, fix=fix)
    assert (tracer_limit_cuda.launches,
            tracer_limit_cuda.slab_launches) == counts
    assert _kerr(got, np.asarray(ref)) < KERNEL_TOL
    for a, b in zip(got.split(nlev), np.split(np.asarray(ref), qsize)):
        assert _kerr(a, b) < KERNEL_TOL
    assert torch.equal(slab, got[:, fix.read_lanes.long()].T)
    assert torch.equal(got, tracer_limit_plain(meta, vu, vv, q, dvv, dt, nlev,
                                               mix=tmix, iters=iters))
    # the limiter did work here: the unlimited value differs; with no pass
    # the residual pass alone moves only roundings
    free = tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev)
    if mix:
        free = meta[11] * (float(ca) * mx + float(cb) * free / meta[11])
    if iters:
        assert _err(got, free) > 1e-3
    else:
        assert _err(got, free) < 1e-5


@pytest.mark.parametrize("case", ["random", "mix", "uniform", "pushed_out"])
def test_torch_tracer_limit_conserves_and_bounds(case):
    """Per element and row the limited stage keeps sum(w*y) of the value it
    was handed, to 4e-6 of sum|w*y|, and lands inside the bounds of the
    stage input wherever they are feasible, to 1e-6 of max|q|; a uniform
    element (no room at all) comes back finite."""
    nlev, dt, qsize = 4, 7.5, 3
    p, q, mx = _limit_inputs(qsize, 23, push=0.2)
    meta, vu, vv, _, dvv = p["t"]
    if case == "uniform":
        q = torch.full_like(q, 0.5)
    tmix = (mx, np.float32(0.75), np.float32(0.25)) if case == "mix" else None
    w = meta[11]
    # the value handed to the limiter, from the unlimited kernel
    y_in = tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev, fold_sph=False)
    if case == "mix":
        y_in = 0.75 * mx + 0.25 * y_in
    if case == "pushed_out":
        # a tenth of the nodes far outside: use dt = 0 and a perturbed mx
        rng = np.random.default_rng(7)
        bump = _T((rng.random(tuple(q.shape)) < 0.1).astype(np.float32))
        mx = q + bump * _T(rng.choice([-1.0, 1.0], tuple(q.shape))
                           .astype(np.float32))
        tmix, dt = (mx, 1.0, 0.0), 0.0
        y_in = mx
    out = tracer_limit_cuda(meta, vu, vv, q, dvv, dt, nlev, mix=tmix)
    assert bool(torch.isfinite(out).all())
    y = (out / w).double()
    grp = lambda x: x.reshape(x.shape[0], -1, 16)
    wd = w.double()
    m_in, m_out = grp(wd * y_in.double()).sum(2), grp(wd * y).sum(2)
    scale = grp((wd * y_in.double()).abs()).sum(2)
    assert float(((m_out - m_in).abs() / scale).max()) <= CONSERVE_TOL
    qmin, qmax = grp(q).amin(2).double(), grp(q).amax(2).double()
    wsum = grp(wd[None]).sum(2)
    feasible = (m_in >= wsum * qmin) & (m_in <= wsum * qmax)
    viol = (grp(y) - qmax[..., None]).clamp(min=0) \
        + (qmin[..., None] - grp(y)).clamp(min=0)
    if case == "uniform":
        # qmin = qmax: an element is feasible only if the advected mass is
        # that of the flat value to the last bit, so mass, finiteness and a
        # result that stays flat are what holds
        assert float((grp(y).amax(2) - grp(y).amin(2)).max()) < 1e-4
    else:
        assert feasible.any()
        assert float(viol.amax(2)[feasible].max()) <= \
            BOUNDS_TOL * float(q.abs().max())
    if case == "pushed_out":
        assert float((y_in.double() - y).abs().max()) > 0.5  # it clipped


@pytest.mark.parametrize("wrapper", [tracer_euler_cuda, tracer_limit_cuda])
def test_torch_tracer_wrappers_reject_bad_operands(wrapper):
    p = _packed(2, 4, 2, seed=3)
    meta, vu, vv, q, dvv = p["t"]
    with pytest.raises(ValueError, match="wind row block"):
        wrapper(meta, vu, vv, q, dvv, 0.1, 4, wind_rows=(0, 1))
    with pytest.raises(ValueError, match="q must be"):
        wrapper(meta, vu, vv, q[:6], dvv, 0.1, 4)
    with pytest.raises(ValueError, match="meta"):
        wrapper(meta[:, :-16], vu, vv, q, dvv, 0.1, 4)
    with pytest.raises(ValueError, match="expected torch.float32"):
        wrapper(meta, vu.double(), vv, q, dvv, 0.1, 4)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(meta, vu, vv, q.T.contiguous().T, dvv, 0.1, 4)
    with pytest.raises(TypeError, match="float fields"):
        wrapper(meta, vu, vv, q.to(torch.int32), dvv, 0.1, 4)
    if wrapper is tracer_limit_cuda:
        with pytest.raises(ValueError, match="mix field"):
            wrapper(meta, vu, vv, q, dvv, 0.1, 4, mix=(q[:4], 0.5, 0.5))
        with pytest.raises(ValueError, match="iters"):
            wrapper(meta, vu, vv, q, dvv, 0.1, 4, iters=-1)


def test_torch_pack_qdp_roundtrip():
    """pack_qdp_t stacks tracer-major, as the JAX package's drivers do, and
    unpack_qdp_t inverts it."""
    jcs, cfg, st, g, qdp, vu, vv = _problem(2, 3, 3, seed=6)
    ts, _, _, _ = from_numpy(_np(st), _np(jt.zero_derived(cfg)), _np(g),
                             _np(jt.analytic_hvcoord(cfg)), device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=3, qsize=3)
    want = np.concatenate([np.asarray(j_pack_field(jnp.asarray(
        st.qdp[0][:, i]))) for i in range(3)])
    got = pack_qdp_t(ts, tcfg)
    assert np.array_equal(got.numpy(), want) and got.is_contiguous()
    assert torch.equal(unpack_qdp_t(got, cfg.nelem, 3), ts.qdp[0])


# -- the packed SSPRK3 tracer step -------------------------------------------

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


def _run_packed(p, dt, nlev, limit, eb, qsize):
    dxbt, dybt, jmeta, jvu, jvv, jq = p["j"]
    ref = np.asarray(j_tracer_packed(
        dxbt, dybt, jmeta, jvu, jvv, jq, p["jp"], jnp.asarray(p["rsp"]), dt,
        eb=eb, nlev=nlev, limit=limit, interpret=True))
    meta, vu, vv, q, dvv = p["t"]
    keep = q.clone()
    counts = [w.launches for w in (tracer_euler_cuda, tracer_limit_cuda,
                                   dss_fixup_cuda, dss_sweep_cuda)]
    with jax_third_stage():
        got = ssprk3_tracer_packed_t(dvv, meta, vu, vv, q, p["plan"],
                                     _T(p["rsp"]), dt, nlev, limit=limit)
        plain = ssprk3_tracer_packed_t_plain(dvv, meta, vu, vv, q, p["plan"],
                                             _T(p["rsp"]), dt, nlev,
                                             limit=limit)
    assert [w.launches for w in (tracer_euler_cuda, tracer_limit_cuda,
                                 dss_fixup_cuda, dss_sweep_cuda)] == counts
    assert torch.equal(q, keep)                              # qdp lives on
    assert torch.equal(got, plain)
    return got, ref


def _mass(p, x, qsize, nlev):
    """Global tracer mass sum(sph * q) of each tracer of a packed field."""
    sph = np.asarray(p["t"][0][11], np.float64)
    x = x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float64)
    return [(sph * b).sum() for b in np.split(x, qsize)]


def _hold_packed(p, limit, eb, qsize, nlev=4):
    """Hold the packed step to JAX's twice. At the small step of JAX's own
    tests (dt = 0.02): the field, the global mass against the input's (the
    projected step conserves it; the random winds are discontinuous, so only
    a small step keeps their own mass error below the gate) and the
    continuity. At STEP_DT: the field, the increment, and the mass against
    that of JAX's result."""
    q0 = p["t"][3]
    got, ref = _run_packed(p, 0.02, nlev, limit, eb, qsize)
    assert _err(got, ref) < STEP_TOL
    for m1, m0 in zip(_mass(p, got, qsize, nlev), _mass(p, q0, qsize, nlev)):
        assert abs(m1 / m0 - 1.0) < MASS_TOL
    assert continuity_error_t(got, p["jcs"].gdof) == 0.0
    got, ref = _run_packed(p, STEP_DT, nlev, limit, eb, qsize)
    assert _err(got, ref) < STEP_TOL
    assert _err(got - q0, ref - q0.numpy()) < STEP_TOL
    assert float((got - q0).abs().max()) > 1e-3 * float(q0.abs().max())
    for m1, m0 in zip(_mass(p, got, qsize, nlev), _mass(p, ref, qsize, nlev)):
        assert abs(m1 / m0 - 1.0) < MASS_TOL
    assert continuity_error_t(got, p["jcs"].gdof) == 0.0


@pytest.mark.parametrize("ne,eb,qsize,two_float", [
    (2, 8, 2, False), (2, 8, 1, True), (3, 6, 2, False), (4, 8, 3, False)])
def test_torch_ssprk3_tracer_packed_matches_jax(ne, eb, qsize, two_float):
    """The packed unlimited step (the wrappers on CPU tensors) against
    JAX's in interpret mode: ne 2 and 4 run JAX's producer-fused path, ne 3
    its unfused fallback of odd ne; the port has one path. Field and
    increment at 2e-5; mass at 2e-6; continuity exactly 0."""
    p = _packed(ne, 4, qsize, seed=9, eb=eb, two_float=two_float)
    _hold_packed(p, False, eb, qsize)


@pytest.mark.parametrize("ne,qsize", [(2, 2), (4, 1)])
def test_torch_ssprk3_tracer_packed_limited_matches_jax_fused(ne, qsize):
    """The packed LIMITED step against JAX's fused limit kernel (interpret;
    asserted to have taken the fused path): field and increment at 2e-5,
    mass at 2e-6, continuity exactly 0."""
    p = _packed(ne, 4, qsize, seed=9)
    # the path is noted when JAX traces the step: trace it anew
    jax.clear_caches()
    fastpath.last_path.pop("ssprk3_tracer_packed_t(limit)", None)
    _hold_packed(p, True, 8, qsize)
    assert fastpath.last_path.get("ssprk3_tracer_packed_t(limit)",
                                  "").startswith("fused"), fastpath.last_path


@pytest.mark.parametrize("ne,limit", [(2, False), (2, True), (3, True)])
def test_torch_ssprk3_tracer_packed_matches_field_form(ne, limit):
    """The packed f32 step against the port's own field form run in f32 on
    the same continuous qdp: 3e-4 (rtol and atol) unlimited, 2e-4 limited,
    the limits JAX holds its packed step to. At odd ne too: one path."""
    nlev, dt, qsize = 4, 0.02, 2
    p = _packed(ne, nlev, qsize, seed=9, eb=8 if ne % 2 == 0 else 6)
    meta, vu, vv, q, dvv = p["t"]
    got = ssprk3_tracer_packed_t(dvv, meta, vu, vv, q, p["plan"],
                                 _T(p["rsp"]), dt, nlev, limit=limit)
    qdp, fu, fv = p["field"]
    cfg, jcs = p["cfg"], p["jcs"]
    _, _, tg, _ = from_numpy(_np(p["st"]), _np(jt.zero_derived(cfg)),
                             _np(p["g"]), _np(jt.analytic_hvcoord(cfg)),
                             device="cpu")
    tcfg = Config(nelem=cfg.nelem, nlev=nlev, qsize=qsize)
    ref = ssprk3_tracer_step(_T(qdp), _T(fu), _T(fv), tg, tcfg, dt,
                             gdof=jcs.gdof, ndof=jcs.ndof, limit=limit)
    tol = 2e-4 if limit else 3e-4
    np.testing.assert_allclose(unpack_qdp_t(got, cfg.nelem, nlev).numpy(),
                               ref.numpy(), rtol=tol, atol=tol)


def test_torch_ssprk3_tracer_packed_reads_winds_in_place():
    """wind_rows=(0, 1) on the [4*nlev] state gives the same bits as the
    winds in buffers of their own, with and without the limiter."""
    nlev, dt = 4, 0.02
    p = _packed(2, nlev, 2, seed=9)
    meta, vu, vv, q, dvv = p["t"]
    s = torch.cat([vu, vv, torch.randn(2 * nlev, q.shape[1])])
    for limit in (False, True):
        a = ssprk3_tracer_packed_t(dvv, meta, vu, vv, q, p["plan"],
                                   _T(p["rsp"]), dt, nlev, limit=limit)
        b = ssprk3_tracer_packed_t(dvv, meta, s, s, q, p["plan"],
                                   _T(p["rsp"]), dt, nlev, limit=limit,
                                   wind_rows=(0, 1))
        assert torch.equal(a, b)
