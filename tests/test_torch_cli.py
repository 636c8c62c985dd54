"""The port's CLI and bench helpers on the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinman_sandbox_tpu_torch import bench
from tinman_sandbox_tpu_torch.cli import main

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _golden_diffs(out):
    vals = out.split("golden diffs: T")[1].split()
    return float(vals[0]), float(vals[2]), float(vals[4])


@pytest.mark.parametrize("kernel", ["plain", "cuda"])
def test_torch_cli_golden(capsys, tmp_path, kernel):
    """Array form (plain) and the packed kernel's CPU version (cuda), both
    f64 on the CPU, reproduce the golden arrays under the JAX CLI's limit."""
    rc = main(["--device", "cpu", "--kernel", kernel, "--num-elems", "3",
               "--num-exec", "2", "--golden-check",
               "--timing-file", str(tmp_path / "Timing.dat")])
    out = capsys.readouterr().out
    assert rc == 0
    t, u, v = _golden_diffs(out)
    assert t < 1e-6 and u < 1e-6 and v < 1e-6
    assert "Mgridpoints/s" in out
    assert "caar compute" in (tmp_path / "Timing.dat").read_text()


def test_torch_cli_leapfrog_random_dump(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "--num-elems", "2", "--nlev", "6",
                 "--num-exec", "3", "--init", "random", "--leapfrog",
                 "--dt", "0.05", "--dtype", "float32",
                 "--dump-res", "yes"]) == 0
    out = capsys.readouterr().out
    assert "WARNING" not in out
    assert (tmp_path / "elem_state_t.txt").exists()


@pytest.mark.parametrize("argv,msg", [
    (["--rk"], "--rk requires --ne"),
    (["--ne", "4", "--restore", "ckdir"], "orbax directory checkpoints"),
    (["--prim"], "--prim requires --ne"),
    (["--ne", "2", "--prim", "--leapfrog"],
     "--prim manages its own time-level cadence; drop --leapfrog"),
    (["--ne", "2", "--prim", "--qsize", "0"], "--qsize must be at least 1"),
    (["--hypervis-nu", "1e15"], "--hypervis-nu requires --ne"),
    (["--ne", "2", "--checkpoint", "x"], "orbax directory checkpoints"),
    (["--kernel", "plain"], "only with --device cpu"),
    (["--dtype", "float64"], "float32 only"),
    (["--dss"], "requires --ne"),
])
def test_torch_cli_rejects_unported_and_invalid(capsys, argv, msg):
    assert main(argv) == 2
    assert msg in capsys.readouterr().err


def test_torch_cli_module_entry_reports_unported_dss():
    """The module entry reports a path that has no counterpart (every flag
    is ported now; an orbax directory checkpoint, a path not ending in
    .npz, is not)."""
    r = subprocess.run([sys.executable, "-m", "tinman_sandbox_tpu_torch",
                        "--ne", "2", "--checkpoint", "x"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 2
    assert "orbax directory checkpoints have no counterpart" in r.stderr


@pytest.mark.parametrize("leapfrog", [False, True])
def test_torch_cli_assembled_on_the_cubed_sphere(capsys, leapfrog):
    """--ne 2 --dss on the CPU (the kernel wrappers' plain versions, f64):
    runs, stays finite and positive, and every alias of every dof holds the
    same bits at the end."""
    argv = ["--device", "cpu", "--ne", "2", "--dss", "--num-exec", "2",
            "--nlev", "8"] + (["--leapfrog"] if leapfrog else [])
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "on 24 elements x 8 levels" in out
    assert "structured DSS, cubed sphere ne2" in out
    assert "WARNING" not in out
    assert "nan" not in out.lower()
    spread = float(out.split("over u, v, T, dp")[1].split()[0])
    assert spread == 0.0


def _continuity(out):
    return float(out.split("over u, v, T, dp")[1].split()[0])


@pytest.mark.parametrize("kernel,extra", [
    ("cuda", []), ("cuda", ["--leapfrog", "--hypervis-nu", "1e20"]),
    ("plain", ["--leapfrog", "--hypervis-nu", "1e20"])])
def test_torch_cli_rk_on_the_cubed_sphere(capsys, kernel, extra):
    """--ne 2 --rk on the CPU: the packed SSPRK3 step through the kernel
    wrappers' plain versions (cuda) and the field form (plain), with and
    without hyperviscosity; finite, positive dp3d, and every alias of every
    dof holds the same bits at the end."""
    argv = ["--device", "cpu", "--kernel", kernel, "--ne", "2", "--rk",
            "--num-exec", "2", "--nlev", "6", "--init", "random", "--dt",
            "0.05"] + extra
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "on 24 elements x 6 levels" in out and "SSPRK3" in out
    assert ("hyperviscosity" in out) == bool(extra)
    assert ("projected onto the continuous space" in out) == (kernel == "cuda")
    assert "WARNING" not in out and "nan" not in out.lower()
    assert _continuity(out) == 0.0


def test_torch_cli_dss_with_hyperviscosity(capsys):
    """--ne 2 --dss --hypervis-nu on the CPU: the assembled step, then the
    damping of the fresh level; finite and continuity exactly 0."""
    assert main(["--device", "cpu", "--ne", "2", "--dss", "--num-exec", "2",
                 "--nlev", "8", "--hypervis-nu", "1e20", "--leapfrog"]) == 0
    out = capsys.readouterr().out
    assert "structured DSS + hyperviscosity" in out
    assert "WARNING" not in out and "nan" not in out.lower()
    assert _continuity(out) == 0.0


@pytest.mark.parametrize("kernel,extra", [
    ("cuda", []), ("cuda", ["--hypervis-nu", "1e20"]),
    ("plain", ["--hypervis-nu", "1e20"]), ("plain", [])])
def test_torch_cli_prim_on_the_cubed_sphere(capsys, kernel, extra):
    """--ne 2 --prim --qsize 2 on the CPU: the packed full model step
    through the kernel wrappers' plain versions, chained in the packed
    layout and unpacked once (cuda), and the field form (plain), with and
    without hyperviscosity inside the cadence; finite, positive dp3d, every
    alias of every dof of the state and of the tracers holds the same bits
    at the end, and the tracers moved."""
    argv = ["--device", "cpu", "--kernel", kernel, "--ne", "2", "--prim",
            "--qsize", "2", "--num-exec", "3", "--nlev", "6", "--init",
            "random", "--dt", "0.05"] + extra
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "on 24 elements x 6 levels" in out and "prim (SSPRK3" in out
    assert ("hyperviscosity" in out) == bool(extra)
    assert ("projected onto the continuous space (tracers too)" in out) \
        == (kernel == "cuda")
    assert "WARNING" not in out and "nan" not in out.lower()
    assert _continuity(out) == 0.0
    tracers = out.split("--- tracers: 2 x qdp, continuity")[1].split()
    assert float(tracers[0].rstrip(",")) == 0.0
    assert float(tracers[2]) > 0.0                      # min qdp


def test_torch_cli_prim_packed_matches_explicit_steps(capsys, tmp_path,
                                                      monkeypatch):
    """The CLI's packed --prim chain equals explicit prim_t steps from the
    same projected start: the warm-up does not advance the chain, and the
    final unpack lands in np1 and qdp[1 - qn0]."""
    import dataclasses

    import numpy as np

    from tinman_sandbox_tpu_torch import (
        Config, analytic_hvcoord, random_state, zero_derived)
    from tinman_sandbox_tpu_torch.dist import (
        build_cubed_sphere, dss_project, make_structured_plan, prim_t)

    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "--ne", "2", "--prim", "--qsize", "2",
                 "--num-exec", "2", "--nlev", "4", "--init", "random", "--dt",
                 "0.05", "--hypervis-nu", "1e20", "--dump-res", "yes"]) == 0
    capsys.readouterr()
    kw = dict(dtype=torch.float64, device="cpu")
    cs = build_cubed_sphere(2, **kw)
    cfg = Config(nelem=cs.nelem, nlev=4, qsize=2, dt=0.05)
    state, derived = random_state(cfg, seed=7, **kw), zero_derived(cfg, **kw)
    geom, hv = cs.geometry, analytic_hvcoord(cfg, **kw)

    def proj(x, level):
        out = x.clone()
        out[level] = dss_project(x[level], cs.gdof, cs.ndof, geom.spheremp,
                                 geom.rspheremp)
        return out

    state = dataclasses.replace(
        state, u=proj(state.u, 0), v=proj(state.v, 0), t=proj(state.t, 0),
        dp3d=proj(state.dp3d, 0), qdp=proj(state.qdp, 0))
    plan = make_structured_plan(cs.gdof, 2)
    c = cfg
    for _ in range(2):
        state, derived, c = prim_t(state, derived, geom, hv, plan, c,
                                   nu=1e20, device="cpu")
    # the CLI keeps the time levels fixed and writes the last step into np1;
    # the explicit chain rotates, so its freshest level is c.n0
    def dumped(name, tl):
        with open(tmp_path / f"elem_state_{name}.txt") as f:
            rows = [ln.split(":")[1].split() for ln in f
                    if ln.startswith(f"tl={tl} ")]
        return np.array(rows, np.float64).ravel()

    for name, field in (("t", state.t), ("vx", state.u), ("dp3d", state.dp3d)):
        np.testing.assert_allclose(dumped(name, cfg.np1),
                                   field[c.n0].numpy().ravel(), rtol=1e-13)
        np.testing.assert_allclose(dumped(name, cfg.n0),
                                   field[cfg.n0].numpy().ravel(), rtol=1e-13)


def test_torch_bench_rk_rotation():
    """The bench's --rk mode: s_np1 becomes the next s0, hyperviscosity runs
    in place on it, accumulators run on; equal bit for bit to explicit
    steps."""
    from tinman_sandbox_tpu_torch.dist import (
        apply_hypervis_packed_t_plain, ssprk3_packed_t4_plain)

    const, s0, acc, plan, rsp = bench.make_dynamics_problem(2, 4, "cpu", 0.05)
    scal, meta, qdp, pecnd, dvv = const
    nu = 1e20
    s, a = s0, acc
    for _ in range(2):
        s, phi, *a = ssprk3_packed_t4_plain(scal, meta, s, qdp, pecnd, *a,
                                            dvv, plan, rsp)
        s = apply_hypervis_packed_t_plain(dvv, meta, s, plan, rsp, nu, 0.05, 4)
    keep = s0.clone()
    s2, acc2, phi2 = bench.run_dynamics(const, s0, [x.clone() for x in acc],
                                        plan, rsp, 2, nu, 0.05)
    assert torch.equal(s0, keep)              # the first s0 is not modified
    assert torch.equal(s2, s) and torch.equal(phi2, phi)
    for x, y in zip(acc2, a):
        assert torch.equal(x, y)
    with pytest.raises(SystemExit):
        bench.main(["--rk"])
    with pytest.raises(SystemExit):
        bench.main(["--ne", "2", "--hypervis-nu", "1e15"])


def test_torch_bench_chains_accumulators():
    """Fixed time levels: n chained steps add n identical increments to the
    accumulators, which start at zero."""
    const, acc = bench.make_problem(8, 4, "cpu")
    one = bench.run_steps(const, [a.clone() for a in acc], 1)
    three = bench.run_steps(const, acc, 3)
    torch.testing.assert_close(three[0], one[0], rtol=0, atol=0)
    for a, b in zip(three[2:], one[2:]):
        torch.testing.assert_close(a, 3 * b, rtol=1e-5, atol=1e-6)
    assert bench.bytes_per_step(1024, 72) == 21 * 4 * 1024 * 16 * 72


def _diag(out, label):
    line = out.split(f"{label} diagnostics:")[1].splitlines()[0]
    return {kv.split("=")[0]: float(kv.split("=")[1]) for kv in line.split()}


def test_torch_cli_diag(capsys):
    """--diag prints the initial and final energy and mass diagnostics; the
    initial ones are ops.energy_diagnostics of the init, and the assembled
    step keeps the mass."""
    from tinman_sandbox_tpu_torch import Config, random_state
    from tinman_sandbox_tpu_torch.dist import build_cubed_sphere
    from tinman_sandbox_tpu_torch.ops.diagnostics import energy_diagnostics

    assert main(["--device", "cpu", "--ne", "2", "--dss", "--num-exec", "2",
                 "--nlev", "6", "--init", "random", "--dt", "0.05",
                 "--leapfrog", "--diag"]) == 0
    out = capsys.readouterr().out
    d0, d1 = _diag(out, "initial"), _diag(out, "final")
    assert sorted(d0) == sorted(d1) == ["IE", "KE", "M", "PE"]
    cs = build_cubed_sphere(2, device="cpu")
    cfg = Config(nelem=cs.nelem, nlev=6)
    want = energy_diagnostics(random_state(cfg, seed=7, device="cpu"),
                              cs.geometry.spheremp, cfg)
    for k, v in want.items():
        assert abs(d0[k] / float(v) - 1.0) < 1e-6, k     # printed to 7 digits
    assert abs(d1["M"] / d0["M"] - 1.0) < 1e-3
    assert all(np.isfinite(v) for v in d1.values())


_RESUME = {
    "leapfrog": ["--num-elems", "2", "--nlev", "6", "--init", "random",
                 "--dt", "0.05", "--leapfrog"],
    "prim": ["--ne", "2", "--prim", "--qsize", "2", "--hypervis-nu", "1e20",
             "--init", "random", "--dt", "0.05", "--nlev", "6"],
    "prim-plain": ["--kernel", "plain", "--ne", "2", "--prim", "--init",
                   "random", "--dt", "0.05", "--nlev", "4"],
}


@pytest.mark.parametrize("mode", sorted(_RESUME))
def test_torch_cli_checkpoint_restore_equals_uninterrupted(tmp_path, capsys,
                                                           mode):
    """3 steps at once equal 2 steps, --checkpoint, then --restore and 1
    step, bit for bit at the freshest level (the state, the tracers and the
    derived fields), with the step count carried."""
    base = ["--device", "cpu"] + _RESUME[mode]
    a, b, c = (str(tmp_path / f"{n}.npz") for n in "abc")
    assert main(base + ["--num-exec", "3", "--checkpoint", a]) == 0
    assert main(base + ["--num-exec", "2", "--checkpoint", b]) == 0
    assert main(base + ["--num-exec", "1", "--restore", b, "--checkpoint",
                        c]) == 0
    assert "restored step 2 from" in capsys.readouterr().out
    za, zc = np.load(a), np.load(c)
    ma, mc = (json.loads(bytes(z["meta"]).decode()) for z in (za, zc))
    assert ma["step"] == mc["step"] == 3
    # the levels may differ (the packed --prim chain rotates once a run);
    # each file's n0 and qn0 hold the freshest state
    for f in ("u", "v", "t", "dp3d"):
        assert np.array_equal(za[f"state.{f}"][ma["n0"]],
                              zc[f"state.{f}"][mc["n0"]]), f
    assert np.array_equal(za["state.qdp"][ma["qn0"]],
                          zc["state.qdp"][mc["qn0"]])
    for f in ("vn0_u", "vn0_v", "phi", "omega_p"):
        assert np.array_equal(za[f"derived.{f}"], zc[f"derived.{f}"]), f
