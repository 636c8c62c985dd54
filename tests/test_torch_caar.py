"""The port's CAAR step against the JAX package's on the same numpy inputs:
the array form against caar_xla, the packed plain version against the
Pallas kernels in interpret mode, the full-state wrapper and the leapfrog
loop. Errors are scaled max-abs, |a - b| / max|b|."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.kernels import caar_xla
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    _scalars as j_scalars,
    caar_pallas_packed_t4_lg,
    caar_pallas_t,
    pack_problem_t as j_pack,
    run_leapfrog_pallas_t,
)
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.convert import from_numpy
from tinman_sandbox_tpu_torch.kernels import caar_array
from tinman_sandbox_tpu_torch.kernels.caar_t import (
    caar_packed_t,
    caar_t,
    caar_t4_cuda,
    caar_t4_plain,
    run_leapfrog_t,
)

torch.set_num_threads(2)


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _setup(nelem, nlev, seed, dtype=np.float32, eb=8, dt=600.0,
           derived_seed=None):
    """A JAX problem (numpy arrays) and the same problem in the port."""
    cfg = jt.Config(nelem=nelem, nlev=nlev, elem_block=eb, dt=dt)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=seed))
    dv = cast(jt.zero_derived(cfg))
    if derived_seed is not None:
        rng = np.random.default_rng(derived_seed)
        sh = dv.vn0_u.shape
        dv = dataclasses.replace(dv, **{
            n: rng.uniform(-1, 1, sh).astype(dtype)
            for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    geom = cast(jt.random_geometry(cfg, seed=seed + 1))
    hv = jt.analytic_hvcoord(cfg).astype(dtype)
    port = from_numpy(_np(st), _np(dv), _np(geom), _np(hv), device="cpu")
    tcfg = Config(nelem=nelem, nlev=nlev, dt=dt)
    return (cfg, st, dv, geom, hv), (tcfg, *port)


def _compare_full(jres, tres, np1, tol):
    (js, jd), (ts, td) = jres, tres
    for name in ("u", "v", "t", "dp3d"):
        e = _err(getattr(ts, name)[np1], np.asarray(getattr(js, name))[np1])
        assert e < tol, (name, e)
    for name in ("vn0_u", "vn0_v", "phi", "omega_p"):
        e = _err(getattr(td, name), getattr(jd, name))
        assert e < tol, (name, e)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 3e-6)])
def test_torch_caar_array_matches_caar_xla(dtype, tol):
    (cfg, st, dv, geom, hv), (tcfg, ts, td, tg, th) = _setup(
        8, 10, seed=5, dtype=dtype, derived_seed=6)
    jres = caar_xla(st, dv, geom, hv, cfg, dtype(0.1), dtype(0.5))
    tres = caar_array(ts, td, tg, th, tcfg, 0.1, 0.5, device="cpu")
    _compare_full(jres, tres, cfg.np1, tol)


def test_torch_caar_t4_plain_matches_pallas_lg():
    """Every output of the plain packed step, the in-place accumulators
    included, against caar_pallas_packed_t4_lg in interpret mode (the setup
    of tests/test_caar_pallas_t.py::test_lane_grouped_t4_bitwise_matches_t4
    with nonzero accumulators)."""
    (cfg, st, dv, geom, hv), _ = _setup(64, 8, seed=3, derived_seed=11)
    p = j_pack(st, dv, geom, hv, cfg)
    scal = np.asarray(j_scalars(np.float32(0.1), np.float32(0.7), hv))
    s0 = np.concatenate([np.asarray(p[k]) for k in ("u0", "v0", "t0", "dp0")])
    sm1 = np.concatenate([np.asarray(p[k])
                          for k in ("um1", "vm1", "tm1", "dpm1")])
    tail = [np.asarray(p[k]) for k in ("qdp", "pecnd", "vn0u", "vn0v", "omg")]
    ref = caar_pallas_packed_t4_lg(
        scal, p["dxbt"], p["dybt"], p["ainct"], p["astrt"], p["bstrt"],
        p["meta"], s0, sm1, *tail, nlev=8, lg=2, interpret=True)
    T = lambda x: torch.from_numpy(np.array(x))
    dvv = torch.from_numpy(np.asarray(geom.dvv, np.float32))
    args = (T(scal), T(p["meta"]), T(s0), T(sm1), *map(T, tail))
    plain = caar_t4_plain(*args, dvv)
    # the wrapper on CPU tensors: plain version, accumulators in place
    launches = caar_t4_cuda.launches
    acc = [a.clone() for a in args[6:9]]
    wrapped = caar_t4_cuda(*args[:6], *acc, dvv)
    assert caar_t4_cuda.launches == launches
    assert all(w is a for w, a in zip(wrapped[2:], acc))
    names = ("s1", "phi", "vn0u", "vn0v", "omg")
    for name, a, w, b in zip(names, plain, wrapped, ref):
        assert _err(a, b) < 3e-6, (name, _err(a, b))
        torch.testing.assert_close(w, a, rtol=0, atol=0)


@pytest.mark.parametrize("moist", [True, False])
def test_torch_caar_t_matches_caar_pallas_t(moist):
    (cfg, st, dv, geom, hv), (tcfg, ts, td, tg, th) = _setup(
        16, 12, seed=3, derived_seed=21)
    jres = caar_pallas_t(st, dv, geom, hv, cfg, 0.1, 0.5, moist=moist,
                         interpret=True)
    tres = caar_t(ts, td, tg, th, tcfg, 0.1, 0.5, moist=moist, device="cpu")
    _compare_full(jres, tres, cfg.np1, 3e-6)


@pytest.mark.parametrize("moist", [True, False])
def test_torch_caar_t_f64_matches_caar_xla(moist):
    """The packed plain step (the version the kernel is held against on the
    card) in f64 against caar_xla at 1e-12: tight enough that the smallest
    tendency terms (vorticity, kinetic energy, ~1e-7 of the fields on random
    data) are held, not only the fields they are added to."""
    (cfg, st, dv, geom, hv), (tcfg, ts, td, tg, th) = _setup(
        16, 12, seed=3, dtype=np.float64, derived_seed=21)
    jres = caar_xla(st, dv, geom, hv, cfg, 0.1, 0.5, moist=moist)
    tres = caar_t(ts, td, tg, th, tcfg, 0.1, 0.5, moist=moist, device="cpu")
    _compare_full(jres, tres, cfg.np1, 1e-12)


def test_torch_chip_gate_cases_see_the_vorticity_term():
    """The on-card gate's cases (chip_smoke.caar_cases): the plain f32 step
    is within the gate of the f64 step in every field of every case, and
    removing the vorticity (zero D rows in meta) is below the gate on the
    bench problem but far above it in the ``vort`` case."""
    import chip_smoke
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS

    const, acc = bench.make_problem(8, 12, "cpu", seed=7)
    nlev = 12
    seen = {}
    for case, args in chip_smoke.caar_cases(const, acc):
        want = caar_t4_plain(*(x.double() for x in args))
        errs = chip_smoke.caar_field_errs(caar_t4_plain(*args), want, nlev)
        assert max(errs.values()) < chip_smoke.CAAR_TOL, (case, errs)
        no_vort = args[1].clone()
        for name in ("d00", "d01", "d10", "d11"):
            no_vort[META_COLS.index(name)] = 0
        got = caar_t4_plain(args[0], no_vort, *args[2:])
        ref = caar_t4_plain(*args)
        seen[case] = max(chip_smoke.caar_field_errs(got, ref, nlev).values())
    assert seen["bench"] < chip_smoke.CAAR_TOL, seen
    assert seen["vort"] > 100 * chip_smoke.CAAR_TOL, seen


def test_torch_run_leapfrog_t_matches_run_leapfrog_pallas_t():
    (cfg, st, dv, geom, hv), (tcfg, ts, td, tg, th) = _setup(
        8, 6, seed=33, eb=4, dt=0.05)
    js, jd, jc = run_leapfrog_pallas_t(st, dv, geom, hv, cfg, nsteps=4,
                                       interpret=True)
    ts2, td2, tc = run_leapfrog_t(ts, td, tg, th, tcfg, 4, device="cpu")
    assert (tc.n0, tc.np1, tc.nm1) == (jc.n0, jc.np1, jc.nm1)
    for name in ("u", "v", "t", "dp3d"):
        e = _err(getattr(ts2, name), getattr(js, name))
        assert e < 2e-5, (name, e)
    for name in ("vn0_u", "vn0_v", "omega_p", "phi"):
        e = _err(getattr(td2, name), getattr(jd, name))
        assert e < 2e-5, (name, e)


def test_torch_unstacked_step_equals_stacked_step():
    """caar_packed_t (row 2 of the kernel table) and caar_t4_cuda (rows 1
    and 3) are one function on differently cut buffers."""
    rng = np.random.default_rng(9)
    k, e16 = 5, 48
    f = lambda lo, hi, n=k: torch.from_numpy(
        rng.uniform(lo, hi, (n, e16)).astype(np.float32))
    meta = f(0.5, 1.5, 16)
    scal = torch.tensor([[0.3, 0.5, 740.0, 0.0]])
    dvv = torch.from_numpy(jt.dvv_matrix(np.float32))
    s0 = torch.cat([f(-1, 1), f(-1, 1), f(250, 300), f(10, 20)])
    sm1 = torch.cat([f(-1, 1), f(-1, 1), f(250, 300), f(10, 20)])
    qdp, pecnd = f(0, 1), f(0, 1)
    acc1 = [f(-1, 1) for _ in range(3)]
    acc2 = [a.clone() for a in acc1]
    st = caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, *acc1, dvv)
    un = caar_packed_t(scal, meta, *s0.split(k), *sm1.split(k), qdp, pecnd,
                       *acc2, dvv)
    torch.testing.assert_close(torch.cat(un[:4]), st[0], rtol=0, atol=0)
    for a, b in zip(un[4:], st[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_torch_caar_wrapper_rejects_bad_operands():
    k, e16 = 4, 32
    z = lambda r, c=e16, **kw: torch.zeros(r, c, **kw)
    scal, meta, dvv = torch.zeros(1, 4), z(16), torch.zeros(4, 4)
    good = dict(s0=z(4 * k), sm1=z(4 * k), qdp=z(k), pecnd=z(k),
                vn0u=z(k), vn0v=z(k), omg=z(k))

    def call(**over):
        a = dict(good, **over)
        return caar_t4_cuda(scal, meta, a["s0"], a["sm1"], a["qdp"],
                            a["pecnd"], a["vn0u"], a["vn0v"], a["omg"], dvv)

    with pytest.raises(ValueError):
        call(s0=z(4 * k + 1))                        # row count
    with pytest.raises(ValueError):
        call(qdp=z(k, 2 * e16)[:, ::2])              # not contiguous
    with pytest.raises(ValueError):
        call(pecnd=z(k, dtype=torch.float64))        # mixed dtypes
    with pytest.raises(TypeError):
        caar_t4_cuda(scal.int(), meta.int(), *(v.int() for v in good.values()),
                     dvv.int())
    with pytest.raises(ValueError):
        caar_t4_cuda(scal, meta[:, :24], *(v[:, :24].contiguous()
                                           for v in good.values()), dvv)


def test_torch_entry_points_raise_without_a_card(monkeypatch):
    """device='cuda' with no card raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _, _, _, _), (tcfg, ts, td, tg, th) = _setup(8, 4, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        caar_t(ts, td, tg, th, tcfg, 0.1, 0.5)
    with pytest.raises(RuntimeError, match="cuda"):
        run_leapfrog_t(ts, td, tg, th, tcfg, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        caar_array(ts, td, tg, th, tcfg, 0.1, 0.5, device="cuda")


@pytest.mark.parametrize("driver", ["run_leapfrog", "benchmark_loop"])
def test_torch_drivers_match_jax(driver):
    """The array-form drivers of timeloop/driver.py in f64."""
    from tinman_sandbox_tpu import timeloop as jtl
    from tinman_sandbox_tpu_torch import timeloop as ttl

    (cfg, st, dv, geom, hv), (tcfg, ts, td, tg, th) = _setup(
        4, 6, seed=2, dtype=np.float64, dt=0.05, derived_seed=3)
    if driver == "run_leapfrog":
        js, jd, jc = jtl.run_leapfrog(st, dv, geom, hv, cfg, nsteps=3)
        ts2, td2, tc = ttl.run_leapfrog(ts, td, tg, th, tcfg, nsteps=3,
                                        device="cpu")
        assert (tc.n0, tc.np1, tc.nm1) == (jc.n0, jc.np1, jc.nm1)
    else:
        js, jd = jtl.benchmark_loop(st, dv, geom, hv, cfg, 0.1, 0.5, nsteps=3)
        ts2, td2 = ttl.benchmark_loop(ts, td, tg, th, tcfg, 0.1, 0.5, 3,
                                      device="cpu")
    for name in ("u", "v", "t", "dp3d"):
        assert _err(getattr(ts2, name), getattr(js, name)) < 1e-12, name
    for name in ("vn0_u", "vn0_v", "omega_p", "phi"):
        assert _err(getattr(td2, name), getattr(jd, name)) < 1e-12, name
    assert ttl.check_dp3d(ts2, tcfg) == (
        bool(jtl.check_dp3d(js, cfg)[0]), float(jtl.check_dp3d(js, cfg)[1]))
