"""The port's benchmark sweep (``tinman_sandbox_tpu_torch/tools/bench_all.py``)
against the JAX tool (``tools/bench_all.py``) on the CPU: each entry's
problem function gives the JAX tool's inputs bit for bit from the same seeds
(at cut shapes), one chained step of each entry (the kernels' plain
versions) agrees with the JAX tool's step (Pallas in interpret mode), the
ne30 entry's structured DSS holds the JAX entry's alias-gather DSS, and the
report has the JAX tool's entries and keys. Errors are scaled max-abs,
|a - b| / max|b|."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.step_pallas import (
    caar_dss_pallas_packed as j_caar_dss,
    make_packed_dss as j_packed_dss,
)
from tinman_sandbox_tpu.kernels.caar_pallas import (
    _scalars as j_scalars,
    caar_pallas_packed as j_caar,
    pack_problem as j_pack,
)
from tinman_sandbox_tpu.kernels.layout import (
    block_derivative_ops as j_blocks,
    pack_field as j_pack_field,
    pack_meta as j_pack_meta,
)
from tinman_sandbox_tpu.kernels.saxpby import saxpby as j_saxpby
from tinman_sandbox_tpu.kernels.tracer_pallas import (
    euler_step_pallas_packed as j_euler,
)
from tinman_sandbox_tpu_torch.dist.step_t import caar_dss_structured_packed
from tinman_sandbox_tpu_torch.kernels.caar import caar_packed
from tinman_sandbox_tpu_torch.kernels.saxpby import saxpby_cuda
from tinman_sandbox_tpu_torch.kernels.tracer import euler_packed
from tinman_sandbox_tpu_torch.tools import bench_all

torch.set_num_threads(2)
TOL = 5e-5           # chip_smoke.py's gate: the CAAR and tracer steps
DSS_TOL = 1e-5       # the structured DSS against the alias gather
FIELDS = ("u0", "v0", "t0", "dp0", "um1", "vm1", "tm1", "dpm1", "qdp",
          "pecnd")
ACC = ("vn0u", "vn0v", "omg")
ENTRIES = ("caar_1024x72", "caar_single_element_26lev", "tracer_128x72_q35",
           "ne30_caar_dss_5400elem", "saxpby_triad")


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _cast(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _j_caar_problem(nelem, nlev):
    """The JAX tool's ``bench_caar`` problem."""
    cfg = jt.Config(nelem=nelem, nlev=nlev, elem_block=8)
    st, dv = _cast(jt.random_state(cfg, seed=7)), _cast(jt.zero_derived(cfg))
    geom = _cast(jt.random_geometry(cfg, seed=8))
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    return j_pack(st, dv, geom, hv, cfg), j_scalars(0.1, 1.0, hv), geom


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nelem,nlev", [(16, 8), (8, 26)])
def test_torch_bench_all_caar_inputs_and_step(nelem, nlev):
    """The CAAR entries' inputs are the JAX tool's bit for bit; one chained
    step (``caar_packed`` on the CPU: its plain version) against
    ``caar_pallas_packed`` in interpret mode, each output at 5e-5."""
    p, scal, geom = _j_caar_problem(nelem, nlev)
    const, acc = bench_all.caar_problem(nelem, nlev, "cpu")
    _same(const[0], scal)
    _same(const[1], p["meta"])
    for name, x in zip(FIELDS, const[2:12]):
        _same(x, p[name])
    _same(const[12], geom.dvv)
    for name, x in zip(ACC, acc):
        _same(x, p[name])
    ref = j_caar(scal, p["dxb"], p["dyb"], p["ainc"], p["astr"], p["bstr"],
                 p["meta"], *(p[n] for n in FIELDS), *(p[n] for n in ACC),
                 eb=8, nlev=nlev, interpret=True)
    launches = caar_packed.launches
    got = caar_packed(*const[:-1], *acc, const[-1])
    assert caar_packed.launches == launches
    assert all(a is b for a, b in zip(got[5:8], acc))   # chained in place
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_torch_bench_all_tracer_inputs_and_step():
    """The tracer entry's inputs at 8 x 8 x 3 tracers bit for bit; one step
    against ``euler_step_pallas_packed`` in interpret mode at 5e-5, at the
    entry's dt and, increment on its own, at a dt that carries it."""
    nelem, nlev, qsize = 8, 8, 3
    cfg = jt.Config(nelem=nelem, nlev=nlev, qsize=qsize, elem_block=8)
    st, geom = _cast(jt.random_state(cfg, seed=1)), _cast(
        jt.random_geometry(cfg, seed=2))
    dxb, dyb = j_blocks(8, geom.dvv, jnp.float32)
    meta = j_pack_meta(geom, jnp.zeros((nelem, 4, 4), jnp.float32))
    qt = jnp.transpose(jnp.asarray(st.qdp[0]), (0, 3, 4, 1, 2)).reshape(
        nelem * 16, qsize * nlev)
    vu, vv = j_pack_field(jnp.asarray(st.u[0])), j_pack_field(
        jnp.asarray(st.v[0]))
    tm, tu, tv, tq, tdvv = bench_all.tracer_problem(nelem, nlev, qsize, "cpu")
    for got, want in ((tm, meta), (tu, vu), (tv, vv), (tq, qt),
                      (tdvv, geom.dvv)):
        _same(got, want)
    launches = euler_packed.launches
    for dt in (1e-4, 1e4):
        scal = jnp.zeros((1, 4), jnp.float32).at[0, 0].set(dt)
        ref = np.asarray(j_euler(scal, dxb, dyb, meta, vu, vv, qt, eb=8,
                                 nlev=nlev, qsize=qsize, interpret=True))
        got = euler_packed(tm, tu, tv, tq, tdvv, dt, nlev)
        assert _err(got, ref) < TOL
        if dt > 1:
            assert _err(got - tq, ref - np.asarray(qt)) < TOL
    assert euler_packed.launches == launches


def test_torch_bench_all_ne30_entry_holds_the_alias_gather_dss():
    """The ne30 entry at ne 2: inputs bit for bit the JAX tool's
    ``pack_problem`` (seed 3, ``_scalars(1e-3, 0.01)``) on the cubed
    sphere; one chained step of the port's structured-DSS step against the
    JAX entry's ``caar_dss_pallas_packed`` with ``make_packed_dss`` (the
    alias gather; Pallas in interpret mode) at 1e-5 scaled per output."""
    ne, nlev = 2, 8
    cs = j_build(ne)
    cfg = jt.Config(nelem=cs.nelem, nlev=nlev, elem_block=8)
    st, dv = _cast(jt.random_state(cfg, seed=3)), _cast(jt.zero_derived(cfg))
    geom = _cast(cs.geometry)
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    p = j_pack(st, dv, geom, hv, cfg)
    scal = j_scalars(1e-3, 0.01, hv)
    (tscal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench_all.ne30_problem(ne, nlev, "cpu")
    _same(tscal, scal)
    _same(meta, p["meta"])
    for name, x in zip(FIELDS, (*s0, *sm1, qdp, pecnd)):
        _same(x, p[name])
    for name, x in zip(ACC, acc):
        _same(x, p[name])
    _same(rsp, np.asarray(geom.rspheremp).reshape(-1, 1))
    gr, rr = j_packed_dss(jnp.asarray(cs.gdof), geom.rspheremp)
    ref = j_caar_dss(scal, p["dxb"], p["dyb"], p["ainc"], p["astr"],
                     p["bstr"], p["meta"], *(p[n] for n in FIELDS),
                     *(p[n] for n in ACC), gr, rr, eb=8, nlev=nlev,
                     ndof=cs.ndof, interpret=True)
    got = caar_dss_structured_packed(tscal, meta, *s0, *sm1, qdp, pecnd,
                                     *acc, dvv, plan, rsp)
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert _err(g, r) < DSS_TOL


def test_torch_bench_all_saxpby_inputs_and_step():
    """The triad's x and y are the JAX tool's draws; one step of
    ``saxpby_cuda`` (in place) against the JAX ``saxpby`` interpreted."""
    from jax.experimental.pallas import tpu as pltpu

    x, y = bench_all.saxpby_problem(128, 64, "cpu")
    jx = np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32)
    jy = np.random.default_rng(1).normal(size=(128, 64)).astype(np.float32)
    _same(x, jx)
    _same(y, jy)
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_saxpby(0.999, 0.001, jnp.asarray(jx),
                                  jnp.asarray(jy), block=128))
    out = saxpby_cuda(0.999, 0.001, x, y)
    assert out is x
    assert _err(out, ref) < 1e-6


def test_torch_bench_all_report_on_the_cpu(tmp_path, capsys):
    """``--device cpu`` writes and prints one JSON report with the JAX
    tool's five entries and keys, the backend and each entry's bytes and
    bound; every time positive and finite; no kernel launched."""
    path = tmp_path / "bench_all.json"
    report = bench_all.main(["--device", "cpu", "--out", str(path)])
    assert json.loads(path.read_text()) == report
    assert json.loads(capsys.readouterr().out) == report
    assert report["backend"] == "cpu" and report["card"] is None
    assert [k for k in report if k in ENTRIES] == list(ENTRIES)
    keys = {"caar_1024x72": "gridpoints_per_s",
            "caar_single_element_26lev": "gridpoints_per_s",
            "tracer_128x72_q35": "tracer_gridpoints_per_s",
            "ne30_caar_dss_5400elem": "gridpoints_per_s",
            "saxpby_triad": "gb_per_s"}
    for name, key in keys.items():
        e = report[name]
        for k in (key, "us_per_step", "bytes_per_step", "bound_us"):
            assert np.isfinite(e[k]) and e[k] > 0, (name, k)
        assert set(e["kernel_launches"].values()) == {0}
    assert report["ne30_caar_dss_5400elem"]["nelem"] == 24
    assert report["ne30_caar_dss_5400elem"]["dss"] == "structured"


def test_torch_bench_all_refuses_without_a_card(monkeypatch):
    """Without a card and without ``--device cpu`` the tool raises; it does
    not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        bench_all.main([])


def test_torch_bench_all_chain_time_is_the_slope(monkeypatch):
    """``chain_time`` is the JAX tool's ``_chain_time``: the slope between
    the best n-step and 3n-step loops, from one warm-up call."""
    clock = {"t": 0.0}
    monkeypatch.setattr(bench_all.time, "perf_counter", lambda: clock["t"])
    calls = []

    def step(x):
        calls.append(x)
        clock["t"] += 0.5            # a step 0.5 s, a synchronisation 1 s
        return x + 1

    real = bench_all._sync
    monkeypatch.setattr(bench_all, "_sync",
                        lambda dev: clock.__setitem__("t", clock["t"] + 1.0)
                        or real(dev))
    per = bench_all.chain_time(step, 0, n=3, reps=2, device="cpu")
    assert per == pytest.approx(0.5)
    assert len(calls) == 1 + 2 * (3 + 9)
