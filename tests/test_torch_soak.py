"""The port's long-run gates on the assembled step and the full model step
(mirrors tests/test_soak.py).

The raw CAAR apply is not iterable under time-level rotation: HOMME closes
it with DSS and rspheremp. So the leapfrog gate runs the assembled step:
the port's ``dist.caar_dss_step`` (f64, the CPU) against the JAX package's
f64 NumPy oracle ``caar_ref`` followed by an independent ``np.add.at`` DSS,
100 leapfrog steps on a real ne 2 cubed sphere, at the JAX test's scaled
atol of 1e-10 per field, with dp3d kept positive.

The prim soak (slow, as in the JAX suite) runs 100 steps of the port's
``timeloop.prim.prim_run_step`` (SSPRK3 dynamics + DSS, limited tracers
subcycled twice) from the analytic init and gates on what the JAX test
gates on: every value finite, dp3d positive, each norm under
10 x (its start + 1)."""
import dataclasses

import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.ref import caar_ref as j_caar_ref
from tinman_sandbox_tpu.timeloop import rotated as j_rotated
from tinman_sandbox_tpu_torch import Config, analytic_hvcoord, analytic_state
from tinman_sandbox_tpu_torch import zero_derived
from tinman_sandbox_tpu_torch.convert import from_numpy
from tinman_sandbox_tpu_torch.dist import build_cubed_sphere, caar_dss_step
from tinman_sandbox_tpu_torch.ops.norms import state_norms
from tinman_sandbox_tpu_torch.timeloop.driver import check_dp3d, rotated
from tinman_sandbox_tpu_torch.timeloop.prim import prim_run_step

torch.set_num_threads(2)
FIELDS = ("u", "v", "t", "dp3d")


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _numpy_dss_scaled(x, gdof, ndof, rspheremp):
    """An independent DSS (np.add.at) for the oracle side."""
    nelem, nlev = x.shape[0], x.shape[1]
    acc = np.zeros((ndof, nlev))
    cols = np.moveaxis(x, 1, -1).reshape(-1, nlev)          # [e*16, nlev]
    np.add.at(acc, gdof.reshape(-1), cols)
    out = acc[gdof.reshape(-1)].reshape(nelem, 4, 4, nlev)
    return rspheremp[:, None] * np.moveaxis(out, -1, 1)


def test_torch_100_step_assembled_leapfrog_vs_oracle():
    jcs = j_build(2)
    jcfg = jt.Config(nelem=jcs.nelem, nlev=8)
    jst = jt.random_state(jcfg, seed=77)
    jdv = jt.zero_derived(jcfg)
    jhv = jt.analytic_hvcoord(jcfg)
    geom = jcs.geometry
    gdof, ndof = np.asarray(jcs.gdof), jcs.ndof
    rsp = np.asarray(geom.rspheremp)
    st, dv, g, hv = from_numpy(_np(jst), _np(jdv), _np(geom), _np(jhv),
                               device="cpu")
    cfg = Config(nelem=jcs.nelem, nlev=8)
    dt2, eta = 10.0, 0.01

    st_o, dv_o, jc = jst, jdv, jcfg
    c = cfg
    for _ in range(100):
        # oracle: raw CAAR, then the independent assembly of np1
        st_o, dv_o = j_caar_ref(st_o, dv_o, geom, jhv, jc, dt2=dt2,
                                eta_ave_w=eta)
        for name in FIELDS:
            arr = np.asarray(getattr(st_o, name))
            arr[jc.np1] = _numpy_dss_scaled(arr[jc.np1], gdof, ndof, rsp)
        st, dv = caar_dss_step(st, dv, g, hv, gdof, ndof, c, dt2, eta,
                               device="cpu")
        jc, c = j_rotated(jc), rotated(c)

    for name in FIELDS:
        a = getattr(st, name).numpy()
        b = np.asarray(getattr(st_o, name))
        assert np.isfinite(b).all(), f"oracle {name} not finite"
        scale = np.max(np.abs(b))
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-10,
                                   err_msg=name)
    ok, mn = check_dp3d(st, c)
    assert ok, f"dp3d positivity lost (min {mn})"


@pytest.mark.slow
def test_torch_100_step_analytic_init_prim_soak():
    cs = build_cubed_sphere(2, device="cpu")
    cfg = Config(nelem=cs.nelem, nlev=8, dt=0.05)
    kw = dict(device="cpu")
    st, dv = analytic_state(cfg, **kw), zero_derived(cfg, **kw)
    hv = analytic_hvcoord(cfg, **kw)
    n0 = state_norms(st)
    c = cfg
    for _ in range(100):
        st, dv, c = prim_run_step(st, dv, cs.geometry, hv, c, cs.gdof,
                                  cs.ndof, nu=0.0, qsplit=2,
                                  limit_tracers=True, device="cpu")
    for name in FIELDS + ("qdp",):
        assert bool(torch.isfinite(getattr(st, name)).all()), name
    ok, mn = check_dp3d(st, c)
    assert ok, f"dp3d went nonpositive: {mn}"
    n1 = state_norms(st)
    for k in ("v", "T", "dp"):
        assert np.isfinite(n1[k])
        assert n1[k] < 10.0 * (n0[k] + 1.0), (k, n0[k], n1[k])
