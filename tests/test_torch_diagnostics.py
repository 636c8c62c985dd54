"""The port's global energy and mass diagnostics (``ops.diagnostics``)
against the JAX package's on the same numpy inputs, and the properties of
``tests/test_diagnostics.py`` on the port alone.

Tolerances: 1e-12 relative for the port against JAX and against numpy
(both compute in f64; only the summation order differs); the mass of the
assembled step is conserved to 1e-11 relative (JAX's own limit).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu import Config as JConfig
from tinman_sandbox_tpu import random_state as j_random_state
from tinman_sandbox_tpu.ops.diagnostics import (
    energy_diagnostics as j_energy,
    energy_diagnostics_packed_t as j_energy_packed,
)
from tinman_sandbox_tpu_torch import (
    Config,
    analytic_hvcoord,
    random_state,
    zero_derived,
)
from tinman_sandbox_tpu_torch.device import from_arrays
from tinman_sandbox_tpu_torch.dist import (
    build_cubed_sphere,
    caar_dss_step,
    dss_project,
)
from tinman_sandbox_tpu_torch.kernels.layout import pack_field_t, pack_meta_t
from tinman_sandbox_tpu_torch.ops.diagnostics import (
    energy_diagnostics,
    energy_diagnostics_packed_t,
    global_integral,
)
from tinman_sandbox_tpu_torch.state import State
from tinman_sandbox_tpu_torch.timeloop import apply_hyperviscosity

torch.set_num_threads(2)
TOL = 1e-12
KEYS = ("KE", "IE", "PE", "M")


def _rel(a, b):
    return abs(float(a) / float(b) - 1.0) if float(b) else abs(float(a))


def _state_pair(seed=2, nelem=3, nlev=5, dtype=np.float64):
    jst = j_random_state(JConfig(nelem=nelem, nlev=nlev), seed=seed)
    arrays = {f.name: np.asarray(getattr(jst, f.name), dtype)
              for f in dataclasses.fields(jst)}
    return jst, from_arrays(State, arrays, device="cpu"), arrays


def test_torch_diagnostics_values_match_numpy():
    cfg = Config(nelem=3, nlev=5)
    _, st, _ = _state_pair()
    sph = np.random.default_rng(3).uniform(0.5, 1.5, (3, 4, 4))
    d = energy_diagnostics(st, torch.from_numpy(sph), cfg)
    assert all(d[k].dtype == torch.float64 for k in KEYS)
    w = sph[:, None]
    u, v, t, dp = (getattr(st, n)[cfg.n0].numpy()
                   for n in ("u", "v", "t", "dp3d"))
    g = 9.80616
    assert _rel(d["KE"], np.sum(w * 0.5 * (u * u + v * v) * dp) / g) < TOL
    assert _rel(d["IE"], 1005.0 * np.sum(w * t * dp) / g) < TOL
    phis = st.phis.numpy()[:, None]
    assert _rel(d["PE"], np.sum(w * phis * dp) / g) < TOL
    assert _rel(d["M"], np.sum(w * dp) / g) < TOL
    assert _rel(global_integral(st.dp3d[0], torch.from_numpy(sph)),
                np.sum(w * st.dp3d[0].numpy())) < TOL


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("tl", [None, 1])
def test_torch_diagnostics_match_jax(dtype, tl):
    """The field form against JAX's, in f64 whatever the state's dtype."""
    jst, st, arrays = _state_pair(seed=4, dtype=dtype)
    jst = type(jst)(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jcfg, cfg = JConfig(nelem=3, nlev=5), Config(nelem=3, nlev=5)
    sph = np.random.default_rng(5).uniform(0.5, 1.5, (3, 4, 4)).astype(dtype)
    want = j_energy(jst, jnp.asarray(sph), jcfg, tl=tl)
    got = energy_diagnostics(st, torch.from_numpy(sph), cfg, tl=tl)
    for k in KEYS:
        assert _rel(got[k], want[k]) < TOL, k


def test_torch_diagnostics_packed_match_jax_and_field():
    """The packed form against JAX's on the same [4*nlev, E16] state and
    [16, E16] meta, and against the port's field form."""
    cs = build_cubed_sphere(2, device="cpu")
    cfg = Config(nelem=cs.nelem, nlev=4)
    st = random_state(cfg, seed=6, device="cpu")
    s = torch.cat([pack_field_t(getattr(st, n)[cfg.n0])
                   for n in ("u", "v", "t", "dp3d")])
    meta = pack_meta_t(cs.geometry, st.phis, torch.float64)
    want = j_energy_packed(jnp.asarray(s.numpy()), jnp.asarray(meta.numpy()),
                           nlev=cfg.nlev)
    got = energy_diagnostics_packed_t(s, meta, cfg.nlev)
    field = energy_diagnostics(st, cs.geometry.spheremp, cfg)
    for k in KEYS:
        assert _rel(got[k], want[k]) < TOL, k
        assert _rel(got[k], field[k]) < TOL, k
    # an f32 state is diagnosed in f64 as well
    got32 = energy_diagnostics_packed_t(s.float(), meta.float(), cfg.nlev)
    assert all(got32[k].dtype == torch.float64 for k in KEYS)
    assert _rel(got32["M"], got["M"]) < 1e-6


def test_torch_mass_conserved_by_assembled_step():
    """The DSS-assembled dp3d update conserves the global mass (the port's
    counterpart of tests/test_diagnostics.py's case)."""
    cs = build_cubed_sphere(3, device="cpu")
    cfg = Config(nelem=cs.nelem, nlev=4)
    st = random_state(cfg, seed=6, device="cpu")
    dv = zero_derived(cfg, device="cpu")
    hv = analytic_hvcoord(cfg, device="cpu")
    g = cs.geometry

    def cont(x):
        out = x.clone()
        out[cfg.n0] = dss_project(x[cfg.n0], cs.gdof, cs.ndof, g.spheremp,
                                  g.rspheremp)
        out[cfg.nm1] = out[cfg.n0]
        return out

    st = dataclasses.replace(st, u=cont(st.u), v=cont(st.v), t=cont(st.t),
                             dp3d=cont(st.dp3d))
    before = energy_diagnostics(st, g.spheremp, cfg, tl=cfg.n0)
    out, _ = caar_dss_step(st, dv, g, hv, cs.gdof, cs.ndof, cfg, 50.0, 1.0,
                           device="cpu")
    after = energy_diagnostics(out, g.spheremp, cfg, tl=cfg.np1)
    assert _rel(after["M"], before["M"]) < 1e-11


def test_torch_hyperviscosity_dissipates_ke():
    cs = build_cubed_sphere(3, device="cpu")
    cfg = Config(nelem=cs.nelem, nlev=3)
    st = random_state(cfg, seed=12, device="cpu")
    g = cs.geometry
    noise = torch.from_numpy(np.random.default_rng(1).normal(
        size=(cs.nelem, cfg.nlev, 4, 4)))
    c = dss_project(noise, cs.gdof, cs.ndof, g.spheremp, g.rspheremp)
    u, v = st.u.clone(), st.v.clone()
    u[cfg.np1], v[cfg.np1] = c, 0.7 * c
    st = dataclasses.replace(st, u=u, v=v)
    before = energy_diagnostics(st, g.spheremp, cfg, tl=cfg.np1)
    out = apply_hyperviscosity(st, g, cs.gdof, cs.ndof, cfg, nu=1e21,
                               dt=10.0, device="cpu")
    after = energy_diagnostics(out, g.spheremp, cfg, tl=cfg.np1)
    assert float(after["KE"]) < float(before["KE"])
    assert float(after["M"]) == float(before["M"])      # dp is not damped
