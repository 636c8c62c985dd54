"""The port's CLI and bench helpers on the CPU."""
import os
import subprocess
import sys

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
    (["--rk"], "not yet ported"),
    (["--ne", "4", "--prim"], "not yet ported"),
    (["--kernel", "plain"], "only with --device cpu"),
    (["--dtype", "float64"], "float32 only"),
    (["--dss"], "requires --ne"),
])
def test_torch_cli_rejects_unported_and_invalid(capsys, argv, msg):
    assert main(argv) == 2
    assert msg in capsys.readouterr().err


def test_torch_cli_module_entry_reports_unported_dss():
    """The module entry reports a flag whose path is not ported (--dss is
    ported now; --rk, the SSPRK3 path, is not)."""
    r = subprocess.run([sys.executable, "-m", "tinman_sandbox_tpu_torch",
                        "--rk"], capture_output=True, text=True, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 2
    assert "not yet ported" in r.stderr


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
