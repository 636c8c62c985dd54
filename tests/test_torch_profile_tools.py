"""The port's stage-breakdown tools (``tinman_sandbox_tpu_torch/tools/
profile_{prim,dss,limiter,dss_ne120}.py``) against the JAX scripts
(``tools/profile_*.py``) on the CPU at ne 2 and 4 levels: each tool's
inputs bit for bit the JAX script's own (seeds 7 and 8, the Config, the
packed problem), each stage's callable run once (the kernels' plain
versions) against its JAX counterpart in interpret mode, the tool's
dynamics -> hyperviscosity -> tracers chain bit for bit one
``prim_step_packed_t4``, the limiter's ladder with its ``iters=0`` rung,
the reports' keys and their "not applicable" entries, ``stage_time`` and
the in-place tracer draw of ``bench.make_prim_problem``.

Tolerances (scaled max-abs, |a - b| / max|b|): 2e-5 for a packed f32 step
against JAX's (tests/test_torch_prim.py), 3e-6 for one CAAR kernel call
(its tendencies are summed in another order than the Pallas kernel's
matrix contractions), 1e-6 for a DSS (XLA on the CPU contracts the sweep's
two-product sums into FMAs; the port rounds each product). The tracer and
step comparisons run at dt 200 (nu 1e18), where f32 resolves what a step
adds (at the tools' dt 0.1 the tracers move below an ulp at ne 2)."""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.step_pallas import (
    apply_hypervis_packed_t as j_hypervis,
    caar_dss_structured_packed_t4 as j_caar_dss,
    prim_step_packed_t4 as j_prim,
    ssprk3_packed_t4 as j_ssprk3,
    ssprk3_tracer_packed_t as j_tracers,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_2f
from tinman_sandbox_tpu.kernels.caar_pallas import _scalars as j_scalars
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    caar_pallas_packed_t4 as j_caar,
    pack_problem_t as j_pack,
)
from tinman_sandbox_tpu.kernels.dss_pallas import (
    dss_structured_t_pallas as j_dss,
)
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field
from tinman_sandbox_tpu.kernels.layout import pack_meta_t as j_pack_meta
from tinman_sandbox_tpu.kernels.tracer_pallas_t import (
    tracer_euler_pallas_packed_t as j_euler,
)
from tinman_sandbox_tpu_torch import bench
from tinman_sandbox_tpu_torch.dist.step_t import prim_step_packed_t4
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_structured_t_cuda, fix_tables)
from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
from tinman_sandbox_tpu_torch.profiling import STAGE_REPS, stage_time
from tinman_sandbox_tpu_torch.tools import (
    profile_dss, profile_dss_ne120, profile_limiter, profile_prim)

torch.set_num_threads(2)
NE, NLEV = 2, 4
STEP_TOL = 2e-5
CAAR_TOL = 3e-6
DSS_TOL = 1e-6
DT, NU = 200.0, 1e18          # tests/test_torch_prim.py's long step
FIELDS = ("u0", "v0", "t0", "dp0")
FIELDS_M1 = ("um1", "vm1", "tm1", "dpm1")


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _cast(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _j_packed(seed, qsize=1, eb=8):
    """The JAX scripts' host problem: (cfg, cs, st, geom, hv, p)."""
    cs = j_build(NE)
    cfg = jt.Config(nelem=cs.nelem, nlev=NLEV, elem_block=eb, qsize=qsize)
    st = _cast(jt.random_state(cfg, seed=seed))
    geom = _cast(cs.geometry)
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    return cfg, cs, st, geom, hv, j_pack(st, _cast(jt.zero_derived(cfg)),
                                         geom, hv, cfg)


def _stack(p, names):
    return np.concatenate([np.asarray(p[n]) for n in names])


def _j_consts(p):
    return tuple(jnp.asarray(p[k]) for k in ("dxbt", "dybt", "ainct",
                                             "astrt", "bstrt"))


def _same_plan(plan, jplan):
    assert plan.ne == jplan.ne
    assert [tuple(e) for e in plan.edges] == [tuple(e) for e in jplan.edges]
    assert np.array_equal(np.asarray(plan.corner_rows),
                          np.asarray(jplan.corner_rows))


# -- each tool's inputs are the JAX script's ----------------------------------

def test_torch_profile_prim_inputs_are_the_jax_scripts():
    """The JAX profile_prim's problem (Config(nelem, nlev), random_state
    seed 7, the sphere's geometry, _scalars(0.1, 1.0, hv)) is the port's
    packed problem bit for bit; the tool's start is that problem projected
    (rsp*DSS(sph*x), which the packed steps need), bit for bit the port's
    projection of JAX's arrays, with the two-float rspheremp of JAX's
    rsp_lanes_2f."""
    cfg, cs, st, geom, hv, p = _j_packed(7)
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(NE, NLEV, "cpu")
    _same(scal, j_scalars(np.float32(0.1), np.float32(1.0), hv))
    _same(meta, p["meta"])
    for got, name in ((qdp, "qdp"), (pecnd, "pecnd")):
        _same(got, p[name])
    _same(s0, _stack(p, FIELDS))
    _same(sm1, _stack(p, FIELDS_M1))
    for a, name in zip(acc, ("vn0u", "vn0v", "omg")):
        _same(a, p[name])
    _same(dvv, np.asarray(geom.dvv, np.float32))
    _same_plan(plan, j_plan(cs.gdof, NE))
    _same(rsp, j_rsp_2f(np.asarray(geom.spheremp, np.float32), cs.gdof,
                        cs.ndof))
    (tscal, tmeta, tpec, tdvv), ts0, tq, tacc, tplan, trsp, gdof = \
        profile_prim.problem(NE, NLEV, 3, "cpu")
    assert torch.equal(tscal, scal) and torch.equal(tmeta, meta)
    assert np.array_equal(np.asarray(gdof), np.asarray(cs.gdof))
    sph = meta[META_COLS.index("spheremp")]
    j_s0 = torch.from_numpy(np.array(_stack(p, FIELDS)))
    assert torch.equal(ts0, dss_structured_t_cuda(sph * j_s0, plan, rsp))
    j_q = torch.from_numpy(np.array(p["qdp"]))
    assert torch.equal(tq[:NLEV], dss_structured_t_cuda(j_q * sph, plan, rsp))
    assert tq.shape == (3 * NLEV, 6 * NE * NE * 16)


def test_torch_profile_dss_inputs_are_the_jax_scripts():
    """profile_dss's problem: random_state seed 8, _scalars(0.5, 1.0, hv),
    the one-float rspheremp row, the structured plan: bit for bit the JAX
    script's."""
    cfg, cs, st, geom, hv, p = _j_packed(8)
    (scal, meta, qdp, pecnd, dvv), s0, sm1, acc, plan, rsp, gdof = \
        profile_dss.problem(NE, NLEV, "cpu")
    _same(scal, j_scalars(0.5, 1.0, hv))
    _same(meta, p["meta"])
    _same(qdp, p["qdp"])
    _same(pecnd, p["pecnd"])
    _same(s0, _stack(p, FIELDS))
    _same(sm1, _stack(p, FIELDS_M1))
    for a, name in zip(acc, ("vn0u", "vn0v", "omg")):
        _same(a, p[name])
    _same(rsp, np.asarray(geom.rspheremp, np.float32).reshape(1, -1))
    _same_plan(plan, j_plan(cs.gdof, NE))


def test_torch_profile_limiter_inputs_are_the_jax_scripts():
    """profile_limiter's problem at qsize 3: JAX's Config(elem_block=8,
    qsize), random_state seed 8 (drawn here without the second qdp level,
    the same stream), pack_problem_t's meta with the state's phis, the
    stacked n0 state and qdp[qn0] tracer-major, the one-float rspheremp
    row: bit for bit."""
    cfg, cs, st, geom, hv, p = _j_packed(8, qsize=3)
    meta, dvv, s0, qdp0, plan, rsp = profile_limiter.problem(NE, NLEV, 3,
                                                             "cpu")
    _same(meta, p["meta"])
    _same(dvv, np.asarray(geom.dvv, np.float32))
    _same(s0, _stack(p, FIELDS))
    _same(qdp0, np.concatenate([
        np.asarray(j_pack_field(jnp.asarray(st.qdp[cfg.qn0, :, q],
                                            jnp.float32)))
        for q in range(3)]))
    _same(rsp, np.asarray(geom.rspheremp, np.float32).reshape(1, -1))
    _same_plan(plan, j_plan(cs.gdof, NE))


def test_torch_profile_dss_ne120_inputs_are_the_jax_scripts():
    """profile_dss_ne120's problem (``bench.make_assembled_problem``): its
    metric rows are those of the JAX script's random_packed_problem_t with
    the sphere's geometry (pack_meta_t with phis 0) and its rspheremp JAX's
    rsp_lanes_2f, bit for bit. The state draws are another stream: the JAX
    script draws with jax.random at every size, the port with a
    torch.Generator from bench.DIRECT_NELEM elements on (on the card) and
    below it random_state seed 7 (here: JAX's pack_problem_t's bits)."""
    cfg, cs, st, geom, hv, p = _j_packed(7)
    (scal, meta, qdp, pecnd, dvv), s0, sm1, acc, plan, rsp, secs = \
        profile_dss_ne120.problem(NE, NLEV, torch.device("cpu"))
    _same(meta[:META_COLS.index("phis")],
          np.asarray(j_pack_meta(geom, np.zeros((cs.nelem, 4, 4),
                                                np.float32),
                                 np.float32))[:META_COLS.index("phis")])
    _same(rsp, j_rsp_2f(np.asarray(geom.spheremp, np.float32), cs.gdof,
                        cs.ndof))
    _same(s0, _stack(p, FIELDS))
    _same(scal, j_scalars(np.float32(0.1), np.float32(1.0), hv))
    _same_plan(plan, j_plan(cs.gdof, NE))
    assert set(secs) == {"sphere_s", "problem_s"}


# -- each stage against JAX ---------------------------------------------------

def _prim_problem(qsize):
    """The tool's problem at the long step, and JAX's constant operators."""
    const, s0, qdp, acc, plan, rsp, gdof = profile_prim.problem(
        NE, NLEV, qsize, "cpu", dt=DT)
    p = _j_packed(7)[5]
    return const, s0, qdp, acc, plan, rsp, _j_consts(p)


def _np_(x):
    return jnp.asarray(x.numpy())


def test_torch_profile_prim_dynamics_stages_match_jax():
    """The tool's ssprk3_dynamics, hyperviscosity and prim_step stages, one
    call each, against JAX's ssprk3_packed_t4, apply_hypervis_packed_t and
    prim_step_packed_t4 in interpret mode on the same inputs (two-float
    rspheremp), every output at 2e-5."""
    const, s0, qdp, acc, plan, rsp, jc = _prim_problem(2)
    scal, meta, pecnd, dvv = const
    jp, jrsp = j_plan(j_build(NE).gdof, NE), _np_(rsp)
    jacc = tuple(_np_(a) for a in acc)
    done = set()
    # a stage's operands live until the next is asked for: call each as it
    # comes, as the tools do
    for name, chain in profile_prim.stages(const, s0, qdp, acc, plan, rsp,
                                           NU, DT, False):
        if name == "ssprk3_dynamics":
            ref = j_ssprk3(_np_(scal), *jc, _np_(meta), _np_(s0),
                           _np_(qdp[:NLEV]), _np_(pecnd), *jacc, jp, jrsp,
                           eb=8, nlev=NLEV, interpret=True)
            assert _err(chain(1), ref[0]) < STEP_TOL
        elif name == "hyperviscosity":
            ref = j_hypervis(*jc[:2], _np_(meta), _np_(s0), jp, jrsp, NU, DT,
                             eb=8, nlev=NLEV, interpret=True)
            out = chain(1)
            assert _err(out, ref) < STEP_TOL
            assert _err(out - s0, np.asarray(ref) - s0.numpy()) < 1e-3
        elif name == "prim_step":
            ref = j_prim(_np_(scal), *jc, _np_(meta), _np_(s0), _np_(qdp),
                         _np_(pecnd), *jacc, jp, jrsp, NU, eb=8, nlev=NLEV,
                         interpret=True)
            assert _err(chain(1), ref[1]) < STEP_TOL
        else:
            continue
        done.add(name)
    assert done == {"ssprk3_dynamics", "hyperviscosity", "prim_step"}


@pytest.mark.parametrize("limit", [False, True])
def test_torch_profile_prim_tracer_stages_match_jax(limit):
    """The tool's tracer stages, one call each, against JAX in interpret
    mode: the substep against ssprk3_tracer_packed_t (limited or not), the
    Euler kernel against tracer_euler_pallas_packed_t, the closer (fixup
    and sweep with the stage-2 mix) against dss_structured_t_pallas(mix=)
    of the same input, all at 2e-5; with the limiter the limited kernel
    stage against the plain limited stage it launches, and the substep
    moved the tracers."""
    const, s0, qdp, acc, plan, rsp, jc = _prim_problem(2)
    scal, meta, pecnd, dvv = const
    jp, jrsp = j_plan(j_build(NE).gdof, NE), _np_(rsp)
    stages = profile_prim.stages(const, s0, qdp, acc, plan, rsp, NU, DT,
                                 limit)
    seen = []
    for name, chain in stages:
        seen.append(name)
        if name.startswith("tracers_"):
            out = chain(1)
            ref = j_tracers(*jc[:2], _np_(meta), _np_(s0), _np_(s0),
                            _np_(qdp), jp, jrsp, np.float32(DT), eb=8,
                            nlev=NLEV, limit=limit, wind_rows=(0, 1),
                            interpret=True)
            assert _err(out, ref) < STEP_TOL
            assert _err(out - qdp, np.asarray(ref) - qdp.numpy()) < 1e-3
            assert float((out - qdp).abs().max()) > 1e-4
        elif name.startswith("tracer_kernel_"):
            ref = j_euler(jnp.asarray([[DT, 0.0, 0.0, 0.0]], jnp.float32),
                          *jc[:2], _np_(meta), _np_(s0), _np_(s0), _np_(qdp),
                          eb=8, nlev=NLEV, wind_rows=(0, 1), interpret=True)
            assert _err(chain(1), ref) < STEP_TOL
        elif name.startswith("tracer_dss_"):
            e0 = chain(0)
            ref = j_dss(_np_(e0), jp, jrsp,
                        mix=(_np_(qdp), np.float32(0.75), np.float32(0.25)),
                        interpret=True)
            assert _err(chain(1), ref) < DSS_TOL
        elif name.startswith("tracer_limit_kernel_"):
            from tinman_sandbox_tpu_torch.kernels.tracer_t import (
                tracer_limit_plain)
            want = tracer_limit_plain(meta, s0, s0, qdp, dvv, DT, NLEV,
                                      mix=(qdp, 0.75, 0.25), wind_rows=(0, 1))
            assert torch.equal(chain(1), want)
    q = "q2"
    assert seen == ["ssprk3_dynamics", "hyperviscosity", f"tracers_{q}",
                    f"tracer_kernel_{q}"] \
        + ([f"tracer_limit_kernel_{q}"] if limit else []) \
        + [f"tracer_dss_{q}", "prim_step"]


@pytest.mark.parametrize("limit", [False, True])
def test_torch_profile_prim_chain_is_one_prim_step(limit):
    """Dynamics, then hyperviscosity on its output, then the tracers on the
    new winds, as the tool calls them (``profile_prim.compose``), are bit
    for bit one prim_step_packed_t4 on the CPU; each stage's chain of one
    call is that stage's call, and a chain of two is the call twice."""
    const, s0, qdp, acc, plan, rsp, gdof = profile_prim.problem(
        NE, NLEV, 2, "cpu", dt=DT)
    scal, meta, pecnd, dvv = const
    a1, a2 = [a.clone() for a in acc], [a.clone() for a in acc]
    s1, q1, phi = profile_prim.compose(const, s0, qdp, a1, plan, rsp, NU,
                                       DT, limit)
    want = prim_step_packed_t4(scal, meta, s0, qdp, pecnd, *a2, dvv, plan,
                               rsp, NU, NLEV, limit_tracers=limit, dt=DT)
    for got, w in zip((s1, q1, phi, *a1), (want[0], want[1], want[2],
                                           *want[3:])):
        assert torch.equal(got, w)
    stages = dict(profile_prim.stages(const, s0, qdp, acc, plan, rsp, NU, DT,
                                      limit))
    k = [a.clone() for a in acc]
    assert torch.equal(stages["ssprk3_dynamics"](1),
                       profile_prim.dynamics_call(const, s0, qdp, k, plan,
                                                  rsp)[0])
    trc = stages["tracers_q2"]
    once = profile_prim.tracers_call(const, s0, qdp, plan, rsp, DT, limit)
    assert torch.equal(trc(1), once)
    assert torch.equal(trc(2), profile_prim.tracers_call(
        const, s0, once, plan, rsp, DT, limit))


def test_torch_profile_dss_stages_match_jax():
    """profile_dss's stages, one call each, against the JAX script's
    functions in interpret mode: kernel_t4 against caar_pallas_packed_t4
    (3e-6), full_step_t4 against caar_dss_structured_packed_t4 (2e-5),
    full_dss against dss_structured_t_pallas (1e-6); sweep_only (zero
    fixup) is the whole DSS bit for bit off the fix lanes, and
    extract+fixup its values at the fix lanes; the ne120 tool's stages are
    the same callables under its names."""
    const, s0, sm1, acc, plan, rsp, gdof = profile_dss.problem(NE, NLEV,
                                                               "cpu")
    scal, meta, qdp, pecnd, dvv = const
    p = _j_packed(8)[5]
    jc = _j_consts(p)
    jp, jrsp = j_plan(j_build(NE).gdof, NE), _np_(rsp)
    got = dict(profile_dss.stages(const, s0, sm1, acc, plan, rsp))
    jargs = (_np_(scal), *jc, _np_(meta), _np_(s0), _np_(sm1), _np_(qdp),
             _np_(pecnd), *(_np_(a) for a in acc))
    ref = j_caar(*jargs, eb=8, nlev=NLEV, interpret=True)
    assert _err(got["kernel_t4"](1), ref[0]) < CAAR_TOL
    ref = j_caar_dss(*jargs, jp, jrsp, eb=8, nlev=NLEV, interpret=True)
    assert _err(got["full_step_t4"](1), ref[0]) < STEP_TOL
    whole = got["full_dss"](1)
    assert _err(whole, j_dss(_np_(s0), jp, jrsp, interpret=True)) < DSS_TOL
    fix = fix_tables(plan, "cpu")
    free = fix.fix_col < 0
    assert torch.equal(got["sweep_only"](1)[:, free], whole[:, free])
    vd = got["extract+fixup"](1)
    assert torch.equal(vd, whole[:, fix.fix_lanes.long()])
    names = [n for n, _ in profile_dss.stages(const, s0, sm1, acc, plan, rsp,
                                              names=profile_dss_ne120.RENAME)]
    assert [profile_dss_ne120.RENAME[n] for n in names] == [
        "kernel_t4", "full_step", "c_sweep", "c_fixup"]


@pytest.mark.parametrize("rung", ["nolimit", "limit_i0", "limit_i1",
                                  "limit_i2"])
def test_torch_profile_limiter_ladder_matches_jax(rung):
    """Each rung of profile_limiter's ladder, one substep at a long step
    (dt 1e4, so that the limiter clips), against JAX's
    ssprk3_tracer_packed_t with the rung's limit and limit_iters in
    interpret mode at 2e-5; the iters=0 rung is none of its neighbours."""
    meta, dvv, s0, qdp0, plan, rsp = profile_limiter.problem(NE, NLEV, 2,
                                                             "cpu")
    cs = j_build(NE)
    p = _j_packed(8, qsize=2)[5]
    jc = _j_consts(p)
    rungs = dict(profile_limiter.ladder(meta, dvv, s0, qdp0, plan, rsp,
                                        dt=1e4))
    limit, iters = profile_limiter.LADDER[rung]
    got = rungs[rung](1)
    ref = j_tracers(*jc[:2], _np_(meta), _np_(s0), _np_(s0), _np_(qdp0),
                    j_plan(cs.gdof, NE), _np_(rsp), np.float32(1e4), eb=8,
                    nlev=NLEV, limit=limit, wind_rows=(0, 1),
                    limit_iters=iters, interpret=True)
    assert _err(got, ref) < STEP_TOL
    if rung == "limit_i0":
        for other in ("nolimit", "limit_i1"):
            assert _err(got, rungs[other](1)) > 1e-4


# -- the reports --------------------------------------------------------------

def _run(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def _merged(lines):
    out = {}
    for ln in lines:
        out.update(ln)
    return out


def test_torch_profile_tools_reports():
    """Each tool on ``--device cpu`` at ne 2: one JSON line a stage under
    the JAX scripts' names with us_per_call, graph_us_per_call (null on the
    CPU, with the reason), host_us_per_call and the wall clock; profile_prim
    its sum line and ``--gate``'s checks; profile_dss the compact stages as
    the same measurements with their note and scatter_zeros not applicable;
    profile_limiter the ladder, its decomposition and the TPU-only rungs not
    applicable, and ``--json-out``; profile_dss_ne120 its stages and
    full_dense not applicable. Without a card and without ``--device cpu``
    every tool raises."""
    small = ["--device", "cpu", "--ne", str(NE), "--nlev", str(NLEV),
             "--nexec", "1"]
    rep = _merged(_run(profile_prim, small + ["--qsize", "2", "--limit",
                                              "--gate"]))
    for name in ("ssprk3_dynamics", "hyperviscosity", "tracers_q2",
                 "tracer_kernel_q2", "tracer_limit_kernel_q2",
                 "tracer_dss_q2", "prim_step"):
        line = rep[name]
        assert line["clock"] == "wall" and line["us_per_call"] > 0
        assert line["graph_us_per_call"] is None and line["graph_note"]
        assert line["host_us_per_call"] > 0 and line["ggp_per_s"] > 0
    assert rep["sum_us"] > 0 and rep["backend"] == "cpu"
    assert rep["gap_us"] == pytest.approx(rep["prim_step_us"]
                                          - rep["sum_us"])
    g = rep["gates"]
    assert g["continuity"] == 0.0 and g["mass_rel_change"] < 4e-6
    assert g["euler_block_err"] == 0.0 and g["limit_block_err"] == 0.0
    rep = _merged(_run(profile_dss, small))
    for alias, name in profile_dss.SAME_AS.items():
        assert rep[alias]["us_per_call"] == rep[name]["us_per_call"]
        assert name in rep[alias]["note"]
    assert rep["scatter_zeros"].startswith("not applicable: ")
    rep = _merged(_run(profile_dss_ne120, small))
    assert {"kernel_t4", "full_step", "c_sweep", "c_fixup"} <= set(rep)
    assert rep["full_dense"].startswith("not applicable: ")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = profile_limiter.main(small + ["--qsize", "2"])
    assert set(out["stage_us"]) == set(profile_limiter.LADDER)
    assert set(out["not_applicable"]) == {"limit_i2_t2", "limit_i1_t2",
                                          "limit_i2_roll"}
    assert all(v.startswith("not applicable: ")
               for v in out["not_applicable"].values())
    dec = out["decomposition"]
    assert isinstance(dec["iteration1_us_per_block"], float)
    assert dec["minmax_roll_delta_us_per_block"].startswith("not applicable")
    assert out["nblocks"] == 3 and out["jax_nblocks"] == 3
    if not torch.cuda.is_available():
        for module in (profile_prim, profile_dss, profile_limiter,
                       profile_dss_ne120):
            with pytest.raises(RuntimeError, match="cuda"):
                module.main(["--ne", str(NE), "--nlev", str(NLEV)])


def test_torch_profile_limiter_json_out(tmp_path):
    path = tmp_path / "lim.json"
    with contextlib.redirect_stdout(io.StringIO()):
        out = profile_limiter.main(["--device", "cpu", "--ne", str(NE),
                                    "--nlev", str(NLEV), "--qsize", "1",
                                    "--nexec", "1",
                                    "--json-out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))


def test_torch_stage_time_on_the_cpu():
    """stage_time on the CPU: wall-clock, no graph, ms = host_ms; n < 1
    refused; the chain ran its warm-up and each timed run."""
    calls = []
    t = stage_time(lambda n: calls.append(n), 3, "cpu")
    assert calls == [1] + [3] * STAGE_REPS
    assert t["clock"] == "wall" and t["graph_ms"] is None
    assert t["ms"] == t["host_ms"] >= 0.0
    with pytest.raises(ValueError, match="n must be"):
        stage_time(lambda n: None, 0, "cpu")


def test_torch_make_prim_problem_in_place_draw():
    """make_prim_problem's tracers drawn in place into one buffer and
    scaled in place are bit for bit the stacked draw (torch.rand of the
    rows after the first tracer, concatenated, times spheremp) that it
    replaced."""
    (scal, meta, q0, pecnd, dvv), s0, acc, plan, rsp = \
        bench.make_dynamics_problem(NE, NLEV, "cpu", 0.1)
    gen = torch.Generator().manual_seed(7)
    more = torch.rand(2 * NLEV, q0.shape[1], generator=gen)
    sph = meta[META_COLS.index("spheremp")]
    want = dss_structured_t_cuda(torch.cat([q0, more]) * sph, plan, rsp)
    assert torch.equal(bench.make_prim_problem(NE, NLEV, "cpu", 0.1, 3)[2],
                       want)
