"""The port's row layout [E16, nlev] against the JAX package's on the same
numpy inputs: the packing, the row CAAR step against caar_pallas in
interpret mode, the row tracer step against euler_step_pallas, the row
structured DSS bit for bit, the row assembled step against
caar_dss_structured_packed and caar_dss_pallas(dss="structured"), the CLI's
``--layout row`` against the JAX CLI, and the bench's row modes. Errors are
scaled max-abs, |a - b| / max|b|."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.cli import main as jax_cli
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.step_pallas import (
    caar_dss_pallas as j_caar_dss_pallas,
    caar_dss_structured_packed as j_step_row,
)
from tinman_sandbox_tpu.dist.structured_dss import (
    dss_structured as j_dss,
    dss_structured_scaled as j_dss_scaled,
    make_structured_plan as j_plan,
)
from tinman_sandbox_tpu.kernels import layout as jlayout
from tinman_sandbox_tpu.kernels.caar_pallas import (
    _scalars as j_scalars,
    caar_pallas,
    pack_problem as j_pack,
)
from tinman_sandbox_tpu.kernels.tracer_pallas import euler_step_pallas
from tinman_sandbox_tpu_torch import Config, bench
from tinman_sandbox_tpu_torch.cli import main as port_cli
from tinman_sandbox_tpu_torch.convert import from_numpy, plan_from_fields
from tinman_sandbox_tpu_torch.device import from_arrays
from tinman_sandbox_tpu_torch.dist import (
    caar_dss,
    caar_dss_structured_packed,
    continuity_error_t,
    dss_structured,
    dss_structured_scaled,
)
from tinman_sandbox_tpu_torch.grid import Geometry
from tinman_sandbox_tpu_torch.kernels import layout as tlayout
from tinman_sandbox_tpu_torch.kernels.caar import (
    caar,
    caar_packed,
    caar_packed_plain,
    pack_problem,
    run_leapfrog,
)
from tinman_sandbox_tpu_torch.kernels.caar_t import (
    _scalars,
    caar_packed_t,
    pack_problem_t,
    run_leapfrog_t,
)
from tinman_sandbox_tpu_torch.kernels.tracer import (
    euler_packed,
    euler_step_fast,
)
from tinman_sandbox_tpu_torch.timeloop.tracer import euler_step

torch.set_num_threads(2)
F32_TOL = 3e-6       # the JAX package's own f32 limit (tests/test_caar_pallas.py)
F64_TOL = 1e-12
FIELDS = ("u0", "v0", "t0", "dp0", "um1", "vm1", "tm1", "dpm1", "qdp",
          "pecnd")


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _setup(nelem, nlev, seed, dtype=np.float32, geom=None):
    """A JAX problem (random state, random accumulators and pecnd, random or
    the given geometry) and the same problem in the port."""
    cfg = jt.Config(nelem=nelem, nlev=nlev, elem_block=8)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=seed))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 1)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(dtype)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    g = cast(geom if geom is not None else jt.random_geometry(cfg, seed=seed))
    hv = jt.analytic_hvcoord(cfg).astype(dtype)
    port = from_numpy(_np(st), _np(dv), _np(g), _np(hv), device="cpu")
    return (cfg, st, dv, g, hv), (Config(nelem=nelem, nlev=nlev), *port)


def _compare_full(jres, tres, np1, tol):
    (js, jd), (ts, td) = jres, tres
    errs = {n: _err(getattr(ts, n)[np1], np.asarray(getattr(js, n))[np1])
            for n in ("u", "v", "t", "dp3d")}
    errs.update({n: _err(getattr(td, n), getattr(jd, n))
                 for n in ("vn0_u", "vn0_v", "phi", "omega_p")})
    assert max(errs.values()) < tol, errs


def test_torch_row_layout_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 4, 4)).astype(np.float32)
    pj = np.asarray(jlayout.pack_field(x))
    pt = tlayout.pack_field(torch.from_numpy(x))
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tlayout.unpack_field(pt, 5).numpy(),
                                  np.asarray(jlayout.unpack_field(pj, 5)))
    (cfg, st, dv, g, hv), (_, ts, td, tg, th) = _setup(8, 4, seed=2)
    mj = np.asarray(jlayout.pack_meta(g, st.phis, np.float32))
    np.testing.assert_array_equal(
        tlayout.pack_meta(tg, ts.phis, torch.float32).numpy(), mj)


@pytest.mark.parametrize("moist", [True, False])
def test_torch_caar_row_matches_caar_pallas(moist):
    """The full-state row step (the wrapper's plain version on the CPU)
    against caar_pallas, whose caar_pallas_packed kernel runs in interpret
    mode, at the JAX package's f32 limit."""
    (cfg, st, dv, g, hv), (tcfg, ts, td, tg, th) = _setup(16, 12, seed=3)
    jres = caar_pallas(st, dv, g, hv, cfg, 0.1, 0.5, moist=moist,
                       interpret=True)
    tres = caar(ts, td, tg, th, tcfg, 0.1, 0.5, moist=moist, device="cpu")
    _compare_full(jres, tres, cfg.np1, F32_TOL)


def test_torch_caar_packed_row_equals_t():
    """The row wrapper on CPU tensors runs its plain version (same bits,
    accumulators in place, no launch counted), and the row plain version is
    the t plain version transposed, bit for bit."""
    _, (tcfg, ts, td, tg, th) = _setup(16, 6, seed=5)
    scal = _scalars(0.1, 0.5, th, torch.float32, "cpu")
    pr = pack_problem(ts, td, tg, th, tcfg)
    pt = pack_problem_t(ts, td, tg, th, tcfg)
    acc = [pr[n] for n in ("vn0u", "vn0v", "omg")]
    want = caar_packed_plain(scal, pr["meta"], *(pr[n] for n in FIELDS), *acc,
                             pr["dvv"])
    launches = caar_packed.launches
    got = caar_packed(scal, pr["meta"], *(pr[n] for n in FIELDS), *acc,
                      pr["dvv"])
    assert caar_packed.launches == launches
    assert all(a is b for a, b in zip(got[5:], acc))
    tref = caar_packed_t(scal, pt["meta"], *(pt[n] for n in FIELDS),
                         *(pt[n] for n in ("vn0u", "vn0v", "omg")), pt["dvv"])
    for a, b, c in zip(got, want, tref):
        assert torch.equal(a, b) and torch.equal(a.T, c)


def test_torch_run_leapfrog_row_equals_t():
    """The row leapfrog loop (pack once, rotate, unpack once) is the t loop
    on the other layout: the same bits and the same rotated levels."""
    _, (tcfg, ts, td, tg, th) = _setup(8, 6, seed=33)
    tcfg = dataclasses.replace(tcfg, dt=0.05)
    rs, rd, rc = run_leapfrog(ts, td, tg, th, tcfg, 4, device="cpu")
    ps, pd, pc = run_leapfrog_t(ts, td, tg, th, tcfg, 4, device="cpu")
    assert (rc.n0, rc.np1, rc.nm1) == (pc.n0, pc.np1, pc.nm1)
    for name in ("u", "v", "t", "dp3d"):
        assert torch.equal(getattr(rs, name), getattr(ps, name)), name
    for name in ("vn0_u", "vn0_v", "omega_p", "phi"):
        assert torch.equal(getattr(rd, name), getattr(pd, name)), name


@pytest.mark.parametrize("qsize", [1, 4])
def test_torch_euler_row_matches_pallas(qsize):
    """The row tracer step against euler_step_pallas (interpret mode) at the
    JAX package's f32 limit, at dt = 1e4 so that the increment -dt*div
    carries the output (at a short step it sits below f32 resolution of
    qdp), the increment held on its own too; and in f64 against the field
    form timeloop.tracer.euler_step at 1e-12."""
    nelem, nlev, dt = 16, 6, 1e4
    cfg = jt.Config(nelem=nelem, nlev=nlev, qsize=qsize, elem_block=8)
    g = jax.tree.map(lambda x: np.asarray(x, np.float32),
                     jt.random_geometry(cfg, seed=4))
    rng = np.random.default_rng(qsize)
    q = rng.uniform(0, 1, (nelem, qsize, nlev, 4, 4)).astype(np.float32)
    u, v = (rng.uniform(-1, 1, (nelem, nlev, 4, 4)).astype(np.float32)
            for _ in range(2))
    ref = np.asarray(euler_step_pallas(q, u, v, g, cfg, dt, interpret=True))
    tg = from_arrays(Geometry, _np(g), device="cpu")
    T = torch.from_numpy
    launches = euler_packed.launches
    got = euler_step_fast(T(q), T(u), T(v), tg, Config(nelem=nelem, nlev=nlev,
                                                       qsize=qsize), dt,
                          device="cpu")
    assert euler_packed.launches == launches
    assert got.shape == q.shape
    assert _err(got, ref) < F32_TOL
    assert _err(got - T(q), ref - q) < F32_TOL
    g64 = tg.to(dtype=torch.float64)
    q64, u64, v64 = (T(x.astype(np.float64)) for x in (q, u, v))
    field = euler_step(q64, u64, v64, g64, None, dt)
    fast = euler_step_fast(q64, u64, v64, g64, None, dt, device="cpu")
    assert _err(fast - q64, field - q64) < F64_TOL


@pytest.mark.parametrize("ne", [2, 3])
def test_torch_row_dss_bitwise_matches_jax(ne):
    """dss_structured and dss_structured_scaled on the row layout equal the
    JAX package's bit for bit (the same additions in the same order)."""
    jcs = j_build(ne)
    jp = j_plan(jcs.gdof, ne)
    plan = plan_from_fields(jp.ne, jp.edges, jp.corner_rows)
    x = np.random.default_rng(ne).standard_normal(
        (jcs.nelem * 16, 7)).astype(np.float32)
    rsp = np.asarray(jcs.geometry.rspheremp, np.float32).reshape(-1, 1)
    np.testing.assert_array_equal(
        dss_structured(torch.from_numpy(x), plan).numpy(),
        np.asarray(j_dss(jnp.asarray(x), jp)))
    np.testing.assert_array_equal(
        dss_structured_scaled(torch.from_numpy(x), plan,
                              torch.from_numpy(rsp)).numpy(),
        np.asarray(j_dss_scaled(jnp.asarray(x), jp, jnp.asarray(rsp))))


def _row_problem(ne, nlev, seed):
    jcs = j_build(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=nlev, elem_block=8)
    jprob, tprob = _setup(jcs.nelem, nlev, seed, geom=jcs.geometry)
    jp = j_plan(jcs.gdof, ne)
    return jcs, jprob, tprob, jp, plan_from_fields(jp.ne, jp.edges,
                                                   jp.corner_rows)


def test_torch_row_assembled_matches_jax():
    """The row assembled step (row kernel's plain version, then the stacked
    structured DSS) against JAX's caar_dss_structured_packed, kernel in
    interpret mode, at ne 2; every alias of a dof holds the same bits."""
    nlev = 6
    jcs, (cfg, st, dv, g, hv), (tcfg, ts, td, tg, th), jp, plan = \
        _row_problem(2, nlev, seed=7)
    p = j_pack(st, dv, g, hv, cfg)
    rsp = np.asarray(g.rspheremp, np.float32).reshape(-1, 1)
    scal = np.array(j_scalars(np.float32(0.1), np.float32(0.5), hv))
    ref = j_step_row(scal, p["dxb"], p["dyb"], p["ainc"], p["astr"],
                     p["bstr"], p["meta"], *(p[n] for n in FIELDS),
                     p["vn0u"], p["vn0v"], p["omg"], jp, jnp.asarray(rsp),
                     eb=8, nlev=nlev, interpret=True)
    pr = pack_problem(ts, td, tg, th, tcfg)
    got = caar_dss_structured_packed(
        torch.from_numpy(scal), pr["meta"], *(pr[n] for n in FIELDS),
        pr["vn0u"], pr["vn0v"], pr["omg"], pr["dvv"], plan,
        torch.from_numpy(rsp))
    for a, b in zip(got, ref):
        assert _err(a, b) < F32_TOL
    for a in got[:4]:
        assert continuity_error_t(a.T, jcs.gdof) == 0.0


def test_torch_caar_dss_row_matches_caar_dss_pallas():
    """The full-state row assembled step against caar_dss_pallas(dss=
    "structured") at ne 2."""
    jcs, (cfg, st, dv, g, hv), (tcfg, ts, td, tg, th), jp, plan = \
        _row_problem(2, 6, seed=8)
    jres = j_caar_dss_pallas(st, dv, g, hv, jcs.gdof, jcs.ndof, cfg, 0.1,
                             0.5, interpret=True, dss="structured", ne=2)
    tres = caar_dss(ts, td, tg, th, plan, tcfg, 0.1, 0.5, device="cpu")
    _compare_full(jres, tres, cfg.np1, F32_TOL)


def _final_norms(out):
    tail = out.split("Final norms")[1]
    return [float(ln.split("=")[1]) for ln in tail.splitlines()
            if "||" in ln][:3]


@pytest.mark.parametrize("argv", [
    ["--num-elems", "8", "--num-exec", "2", "--nlev", "8"],
    ["--ne", "2", "--dss", "--leapfrog", "--num-exec", "2", "--nlev", "8",
     "--init", "random", "--dt", "0.05"],
], ids=["raw", "dss"])
def test_torch_cli_layout_row_matches_jax_cli(capsys, argv):
    """``--layout row`` on the CPU (the row kernel's plain version, f32)
    against the JAX CLI ``--kernel pallas --layout row --dtype float32``
    (interpret mode): the final norms within 1e-5 relative."""
    assert jax_cli(argv + ["--layout", "row", "--kernel", "pallas",
                           "--dtype", "float32"]) == 0
    ref = _final_norms(capsys.readouterr().out)
    assert port_cli(argv + ["--layout", "row", "--device", "cpu",
                            "--dtype", "float32"]) == 0
    out = capsys.readouterr().out
    assert "row-layout" in out and "WARNING" not in out
    got = _final_norms(out)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert abs(a / b - 1.0) < 1e-5, (got, ref)


@pytest.mark.parametrize("flag", [["--rk"], ["--prim"],
                                  ["--hypervis-nu", "1e15"]])
def test_torch_cli_layout_row_refuses_other_paths(capsys, flag):
    assert port_cli(["--ne", "2", "--layout", "row", *flag]) == 2
    assert f"--layout row has no {flag[0]} form" in capsys.readouterr().err


def test_torch_bench_row_modes():
    """The bench's row raw mode is the t raw mode transposed, bit for bit;
    its assembled mode chains (n0 <- assembled s1, nm1 <- old n0) as two
    explicit steps do; the byte counts are the documented ones."""
    cr, ar = bench.make_problem(8, 4, "cpu", layout="row")
    ct, at = bench.make_problem(8, 4, "cpu")
    orow = bench.run_steps(cr, ar, 2, "row")
    ot = bench.run_steps(ct, at, 2)
    assert torch.equal(torch.cat([x.T for x in orow[:4]]), ot[0])
    for a, b in zip(orow[4:], ot[1:]):
        assert torch.equal(a.T, b)
    const, (s0, sm1), acc, plan, rsp = bench.make_assembled_problem(
        2, 4, "cpu", layout="row")
    scal, meta, qdp, pecnd, dvv = const
    step = lambda a, b, ac: caar_dss_structured_packed(
        scal, meta, *a, *b, qdp, pecnd, *(x.clone() for x in ac), dvv, plan,
        rsp)
    a1 = step(s0, sm1, acc)
    a2 = step(a1[:4], s0, a1[5:])
    (n0, nm1), acc2, phi = bench.run_assembled(
        const, (s0, sm1), [a.clone() for a in acc], plan, rsp, 2,
        layout="row")
    for a, b in zip((*n0, *nm1, phi, *acc2), (*a2[:4], *a1[:4], *a2[4:])):
        assert torch.equal(a, b)
    assert rsp.shape == (384, 1)
    assert bench.assembled_bytes_per_step(30, 72, 2856, layout="row") == \
        (29 * 72 + 1) * 86400 * 4


@pytest.mark.parametrize("r0", [False, True], ids=["rsplit1", "rsplit0"])
@pytest.mark.parametrize("nlev", [72, 400])
def test_torch_row_wrappers_launch_the_row_plan(monkeypatch, r0, nlev):
    """A CUDA call of the row wrappers (reached here by a check that reports
    a card and a stand-in library) hands ``caar_launch`` the row kernel's
    plan: row = 1, ``caar_row_plan``'s (chunks, levels, staged) (staged at
    72 levels, in place at 400), ld = nlev, hyb as two vectors of stride 1
    and etaacc at rsplit=0 only; each call counts one launch."""
    import importlib

    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.caar import caar_packed_rsplit0
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS

    ct = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")

    e16 = 48                                     # a whole and a half tile
    rng = np.random.default_rng(2)
    z = lambda *shape: torch.from_numpy(
        rng.uniform(1, 2, shape).astype(np.float32))
    fields = [z(e16, nlev) for _ in range(13)]
    meta, dvv, scal = z(e16, len(META_COLS)), z(4, 4), z(1, 4)
    hyb, etaacc = z(2, nlev), z(e16, nlev)
    calls = []

    class Lib:
        def caar_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ct, "_check", lambda *a, **kw: torch.device("cuda",
                                                                     0))
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    wrapper = caar_packed_rsplit0 if r0 else caar_packed
    launches = wrapper.launches
    if r0:
        wrapper(scal, hyb, meta, *fields, etaacc, dvv)
    else:
        wrapper(scal, meta, *fields, dvv)
    assert wrapper.launches == launches + 1
    (args,) = calls
    plan = ct.caar_row_plan(e16, nlev, r0)
    assert plan.stash == (nlev == 72)
    assert args[26:29] == (nlev, e16, nlev)
    assert args[31:36] == (1, 1, plan.chunks, plan.levels, int(plan.stash))
    assert args[21:23] == (0, 0)                  # no fix-lane slab
    want = (hyb.data_ptr(), hyb.data_ptr() + 4 * nlev, etaacc.data_ptr()) \
        if r0 else (0, 0, 0)
    assert args[23:26] == want
