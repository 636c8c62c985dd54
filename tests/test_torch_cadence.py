"""The rsplit cadence end to end: the field-form step with the limiter and
the remap against the JAX package's (``tests/test_prim.py::
test_prim_run_with_remap_and_limiter``), the packed cadence of
``examples.packed_cadence`` against the field cadence, and the two examples
and the energy-drift tool run on the CPU at ne = 2.

Tolerances: 1e-12 for the f64 field form against JAX (the same math; sums in
other orders); air and tracer mass conserved through the remap cadence to
1e-9 (JAX's own limits); the f32 packed cadence against the f64 field
cadence at 5e-4 (rtol and atol, the packed-against-field limit of
tests/test_structured_dss.py), each block on its own after 3 steps with one
remap; the packed fixer holds the air mass to 1e-6 relative.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu import Config as JConfig
from tinman_sandbox_tpu import zero_derived as j_zero_derived
from tinman_sandbox_tpu.config import NP, NUM_TIME_LEVELS
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.grid import HybridVCoord as JHybridVCoord
from tinman_sandbox_tpu.ops.diagnostics import energy_diagnostics as j_energy
from tinman_sandbox_tpu.ops.remap import reference_dp as j_reference_dp
from tinman_sandbox_tpu.state import State as JState
from tinman_sandbox_tpu.timeloop.prim import prim_run_step as j_prim_run_step
from tinman_sandbox_tpu_torch import Config, zero_derived
from tinman_sandbox_tpu_torch.convert import from_numpy, unpack_qdp_t
from tinman_sandbox_tpu_torch.dist import (
    continuity_error_t,
    packed_air_mass,
    rsp_2f,
)
from tinman_sandbox_tpu_torch.examples import packed_cadence, simulated_day
from tinman_sandbox_tpu_torch.kernels.layout import unpack_field_t
from tinman_sandbox_tpu_torch.ops.diagnostics import energy_diagnostics
from tinman_sandbox_tpu_torch.state import State
from tinman_sandbox_tpu_torch.timeloop import (
    air_mass,
    checkpoint_meta,
    load_packed_checkpoint,
    prim_run_step,
    save_packed_checkpoint,
)
from tinman_sandbox_tpu_torch.tools import energy_drift

torch.set_num_threads(2)
F64_TOL = 1e-12
MASS_TOL = 1e-9
FIELD_TOL = 5e-4


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_bubble(nlev=6, ne=2):
    """tests/test_prim.py's remap problem: resting isothermal atmosphere
    (280 K, plus a small zonal wind so the step moves the columns) on the
    real hybrid coordinate, qdp 1e-3 of dp."""
    cs = j_build(ne)
    cfg = JConfig(nelem=cs.nelem, nlev=nlev, dt=20.0)
    p0, p_top = 1.0e5, 500.0
    etai = np.linspace(p_top / p0, 1.0, nlev + 1)
    b = ((etai - etai[0]) / (1.0 - etai[0])) ** 1.3
    a = etai - b
    hva = dict(ps0=p0, hyai=a, hybi=b, hyam=0.5 * (a[:-1] + a[1:]),
               hybm=0.5 * (b[:-1] + b[1:]))
    hv = JHybridVCoord(**hva)
    ps = jnp.full((cs.nelem, NP, NP), p0)
    dp_ref = np.asarray(j_reference_dp(hv, ps))
    tile = lambda x: np.broadcast_to(x, (NUM_TIME_LEVELS,) + x.shape).copy()
    wind = 5.0 * np.cos(np.asarray(cs.lat))[:, None] * np.ones_like(dp_ref)
    st = JState(
        u=tile(wind), v=tile(np.zeros_like(dp_ref)),
        t=tile(280.0 * np.ones_like(dp_ref)), dp3d=tile(dp_ref),
        ps_v=tile(np.asarray(ps)), phis=np.zeros((cs.nelem, NP, NP)),
        qdp=np.full((2, cs.nelem, cfg.qsize, nlev, NP, NP), 1e-3)
        * dp_ref[None, :, None])
    dv = j_zero_derived(cfg)
    return cs, cfg, st, dv, hv, hva


def test_torch_prim_run_with_remap_and_limiter_matches_jax():
    """4 field-form steps, qsplit 2, limiter, remap on steps 2 and 4: the
    port against JAX's at 1e-12 after every step; air and tracer mass
    conserved through the cadence."""
    jcs, jcfg, jst, jdv, jhv, hva = _jax_bubble()
    g = jcs.geometry
    st, dv, tg, th = from_numpy(_np(jst), _np(jdv), _np(g), hva, device="cpu")
    cfg = Config(nelem=jcfg.nelem, nlev=jcfg.nlev, dt=jcfg.dt)
    sph = g.spheremp
    m0 = float(j_energy(jst, sph, jcfg)["M"])
    q0 = float(np.sum(np.asarray(sph)[:, None, None]
                      * np.asarray(jst.qdp[jcfg.qn0])))
    gdof = jnp.asarray(jcs.gdof)
    c, jc = cfg, jcfg
    for step in range(4):
        jst, jdv, jc = j_prim_run_step(jst, jdv, g, jhv, jc, gdof, jcs.ndof,
                                       nu=1e14, qsplit=2, limit_tracers=True,
                                       remap=(step % 2 == 1))
        st, dv, c = prim_run_step(st, dv, tg, th, c, jcs.gdof, jcs.ndof,
                                  nu=1e14, qsplit=2, limit_tracers=True,
                                  remap=(step % 2 == 1), device="cpu")
        assert (c.n0, c.np1, c.nm1, c.qn0) == (jc.n0, jc.np1, jc.nm1, jc.qn0)
        for name in ("u", "v", "t", "dp3d", "qdp"):
            e = _err(getattr(st, name), getattr(jst, name))
            assert e < F64_TOL, (step, name, e)
    assert bool(torch.isfinite(st.t).all())
    m1 = float(energy_diagnostics(st, tg.spheremp, cfg, tl=c.n0)["M"])
    assert abs(m1 / m0 - 1.0) < MASS_TOL
    q1 = float((tg.spheremp[:, None, None] * st.qdp[c.qn0]).sum())
    assert abs(q1 / q0 - 1.0) < MASS_TOL


def test_torch_packed_cadence_matches_field_cadence():
    """examples.packed_cadence's cadence (the packed step through the kernel
    wrappers' plain versions, limited tracers, remap + fixer on step 3) at
    ne 2 against the field cadence (prim_run_step with the same two-float
    rspheremp, remap and mass target) from the same state."""
    prob = packed_cadence.make_cadence_problem(2, 4, 2, 20.0, "random",
                                               device="cpu")
    cfg, k = prob["cfg"], prob["cfg"].nlev
    cs, nelem = prob["cs"], prob["cfg"].nelem
    s0, q0 = prob["s"], prob["qdp"]
    mass0 = packed_air_mass(s0, prob["sph_lanes"], k)
    runs = list(packed_cadence.cadence(prob, s0, q0, prob["acc"], 3,
                                       nu=1e20, qsplit=2, rsplit=3,
                                       mass_target=mass0))
    assert [r[4] for r in runs] == [False, False, True]
    _, s, q, _, _ = runs[-1]
    assert continuity_error_t(s[:3 * k], cs.gdof) == 0.0
    assert abs(float(packed_air_mass(s, prob["sph_lanes"], k))
               / float(mass0) - 1.0) < 1e-6

    # the same start in field form, f64
    g = cs.geometry.to(dtype=torch.float64)
    hv = prob["hv"].to(dtype=torch.float64)
    put = lambda x: torch.stack([x] * 3)
    field = [unpack_field_t(s0[i * k:(i + 1) * k].double(), nelem)
             for i in range(4)]
    qf = unpack_qdp_t(q0.double(), nelem, k)
    st = State(u=put(field[0]), v=put(field[1]), t=put(field[2]),
               dp3d=put(field[3]),
               ps_v=torch.zeros(3, nelem, 4, 4, dtype=torch.float64),
               phis=torch.zeros(nelem, 4, 4, dtype=torch.float64),
               qdp=torch.stack([qf, qf]))
    dv = zero_derived(cfg, device="cpu")
    rsp2 = tuple(torch.from_numpy(x).double()
                 for x in rsp_2f(g.spheremp, cs.gdof, cs.ndof))
    target = air_mass(st, g.spheremp, dataclasses.replace(cfg, np1=cfg.n0))
    c = cfg
    for step in range(1, 4):
        st, dv, c = prim_run_step(st, dv, g, hv, c, cs.gdof, cs.ndof,
                                  nu=1e20, qsplit=2, limit_tracers=True,
                                  remap=(step % 3 == 0), rsp2=rsp2,
                                  mass_target=target, device="cpu")
    for i, name in enumerate(("u", "v", "t", "dp3d")):
        want = getattr(st, name)[c.n0]
        got = unpack_field_t(s[i * k:(i + 1) * k], nelem).double()
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale,
                                   rtol=FIELD_TOL, atol=FIELD_TOL,
                                   err_msg=name)
    want = st.qdp[c.qn0]
    got = unpack_qdp_t(q, nelem, k).double()
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale,
                               rtol=FIELD_TOL, atol=FIELD_TOL)


def test_torch_packed_cadence_example_restarts(tmp_path, capsys):
    """The example's --checkpoint restart: 2 steps, then 2 more from the
    checkpoint, equal 4 steps at once (the packed chain bit for bit)."""
    base = ["--ne", "2", "--nlev", "4", "--qsize", "1", "--device", "cpu",
            "--rsplit", "3", "--dt", "20"]
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert packed_cadence.main(base + ["--steps", "4", "--checkpoint",
                                       a]) == 0
    assert packed_cadence.main(base + ["--steps", "2", "--checkpoint",
                                       b]) == 0
    out = str(tmp_path / "drift.json")
    assert packed_cadence.main(base + ["--steps", "2", "--checkpoint", b,
                                       "--drift-out", out]) == 0
    text = capsys.readouterr().out
    assert "restarted packed chain at step 2" in text
    za, zb = np.load(a), np.load(b)
    for key in ("packed.s", "packed.qdp", "packed.vn0u", "packed.omg"):
        assert np.array_equal(za[key], zb[key]), key
    # the fixer's target travels in the meta, the same in both
    assert checkpoint_meta(a) == checkpoint_meta(b)
    assert checkpoint_meta(a)["mass_target"] > 0
    report = json.load(open(out))
    assert report["device"] == "cpu" and report["finite"]
    assert [x["step"] for x in report["samples"]][0] == 2
    assert report["mass_drift_rel"] < 1e-4


def test_torch_packed_cadence_restart_takes_the_stored_mass_target(
        tmp_path):
    """A restart fixes the air mass toward the target in the checkpoint,
    not toward one measured anew: with the stored target moved by 2e-5, the
    air mass after the next remap is the moved target to 1e-6."""
    base = ["--ne", "2", "--nlev", "4", "--qsize", "1", "--device", "cpu",
            "--rsplit", "3", "--dt", "20"]
    path = str(tmp_path / "c.npz")
    assert packed_cadence.main(base + ["--steps", "2", "--checkpoint",
                                       path]) == 0
    s, qdp, acc, step = load_packed_checkpoint(path, device="cpu")
    target = np.float32(checkpoint_meta(path)["mass_target"] * (1 + 2e-5))
    save_packed_checkpoint(path, s, qdp, acc, step, mass_target=target)
    assert packed_cadence.main(base + ["--steps", "1", "--checkpoint",
                                       path]) == 0
    s, *_ = load_packed_checkpoint(path, device="cpu")
    prob = packed_cadence.make_cadence_problem(2, 4, 1, 20.0,
                                               device="cpu")
    mass = float(packed_air_mass(s, prob["sph_lanes"], 4))
    assert checkpoint_meta(path)["mass_target"] == float(target)
    assert abs(mass / float(target) - 1.0) < 1e-6


def test_torch_simulated_day_runs(tmp_path, capsys):
    path = str(tmp_path / "day.npz")
    assert simulated_day.main(["--ne", "2", "--nlev", "4", "--steps", "24",
                               "--device", "cpu", "--checkpoint", path]) == 0
    out = capsys.readouterr().out
    drift = float(out.split("mass drift:")[1].split(";")[0])
    assert drift < 1e-10
    assert "step   24:" in out and os.path.exists(path)


def test_torch_energy_drift_tool(tmp_path):
    assert os.path.basename(energy_drift.DEFAULT_OUT) == \
        "ENERGY_DRIFT_TORCH.json"
    out = str(tmp_path / "drift.json")
    report = energy_drift.main(["--ne", "2", "--nlev", "4", "--steps", "6",
                                "--every", "3", "--device", "cpu",
                                "--out", out])
    assert json.load(open(out)) == json.loads(json.dumps(report))
    assert [s["step"] for s in report["samples"]] == [0, 3, 6]
    assert all(s["dp3d_ok"] for s in report["samples"])
    assert report["device"] == "cpu" and report["card"] is None
    assert report["mass_drift_rel"] < 1e-12


@pytest.mark.parametrize("mod", [packed_cadence, simulated_day, energy_drift])
def test_torch_cadence_entry_points_need_a_card(monkeypatch, mod):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--ne", "2", "--nlev", "4", "--steps", "1"])
