"""The port's f64 oracle against the golden arrays, and the port's copy of
the golden data against the JAX package's."""
import os

import numpy as np
import torch

import tinman_sandbox_tpu_torch as tt
from tinman_sandbox_tpu_torch.golden import golden_caar
from tinman_sandbox_tpu_torch.ref import caar_ref

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_oracle_matches_golden():
    cfg = tt.Config(nelem=3, nlev=72)
    kw = dict(device="cpu")
    new_state, _ = caar_ref(tt.analytic_state(cfg, **kw),
                            tt.analytic_derived(cfg, **kw),
                            tt.analytic_geometry(cfg, **kw),
                            tt.analytic_hvcoord(cfg, **kw), cfg,
                            dt2=1.0, eta_ave_w=1.0)
    gold = golden_caar()
    host = lambda x: x[cfg.np1, 0].numpy()
    # limits of tests/test_golden.py: |T| ~ 2e3..7e3, |v| ~ 1e1..2e2
    assert np.max(np.abs(host(new_state.t) - gold["T"])) < 1e-7
    assert np.max(np.abs(host(new_state.u) - gold["v1"])) < 1e-6
    assert np.max(np.abs(host(new_state.v) - gold["v2"])) < 1e-6


def test_torch_golden_data_is_a_byte_copy():
    paths = [os.path.join(ROOT, pkg, "data", "golden_caar.npz")
             for pkg in ("tinman_sandbox_tpu", "tinman_sandbox_tpu_torch")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_torch_package_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX package."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tinman_sandbox_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    held = {os.path.relpath(f, ROOT) for f in files}
    for name in ("ops/limiter.py", "ops/remap.py", "timeloop/tracer.py",
                 "timeloop/prim.py", "kernels/tracer_t.py", "dist/step_t.py",
                 "kernels/caar.py", "kernels/tracer.py", "kernels/ring_fused.py",
                 "kernels/probe.py", "ops/diagnostics.py",
                 "timeloop/checkpoint.py", "tools/probe_kernel.py",
                 "tools/energy_drift.py", "tools/equiv_check.py",
                 "examples/packed_cadence.py", "examples/simulated_day.py",
                 "cli.py", "bench.py", "profiling.py",
                 "tools/profile_prim.py", "tools/profile_dss.py",
                 "tools/profile_limiter.py", "tools/profile_dss_ne120.py",
                 "dist/sharding.py", "dist/level_sharded.py",
                 "tools/bench_assembled.py"):
        assert os.path.join("tinman_sandbox_tpu_torch", name) in held
    for path in files:
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                code = line.split("#")[0]
                bad = ("import jax" in code or "from jax" in code
                       or "tinman_sandbox_tpu." in code
                       or "from tinman_sandbox_tpu " in code
                       or "import tinman_sandbox_tpu\n" in line
                       or code.rstrip().endswith("import tinman_sandbox_tpu"))
                assert not bad, f"{path}:{ln}: {line.strip()}"
