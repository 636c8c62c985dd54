"""Solid-body rotation of a cosine bell through the port's field-form
SSPRK3 tracer step (mirrors tests/test_advection.py).

A bell carried once round the sphere by solid-body zonal flow must come
back with bounded error and its mass kept: at ne 6, nlev 1, 480 steps of
``timeloop.tracer.ssprk3_tracer_step`` (f64, the CPU), mass to rtol 1e-10,
relative L2 error under 0.3, the peak in (0.6, 1.2). With the limiter, half
a revolution in 240 steps: mass to rtol 1e-10, min > -1e-3, max < 1 + 1e-3.
Both runs start with a prefix held against the JAX package's
``ssprk3_tracer_step`` on the same numbers in f64 (10 steps, and 5 with the
limiter) at 1e-12 scaled max-abs: the same operators, summed in another
order. The bell (``dist.cosine_bell``) is built from the port's cubed
sphere (``sphere_xyz``, ``lat``), which is the JAX package's bit for bit.

The packed f32 step computes every level on its own (a test below), which
the card's bell run relies on for its plain twins.

JAX's limiter unit tests (tests/test_advection.py:62 and :118) are mirrored
by tests/test_torch_tracer.py::test_torch_limit_tracer_properties (cases
mass, bounds, identity and uniform_f32); they are not repeated here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.timeloop.tracer import (
    ssprk3_tracer_step as j_ssprk3_tracer_step,
)
from tinman_sandbox_tpu_torch import CONSTANTS, Config
from tinman_sandbox_tpu_torch.dist import build_cubed_sphere, cosine_bell
from tinman_sandbox_tpu_torch.timeloop.tracer import ssprk3_tracer_step

torch.set_num_threads(2)
NE = 6
PERIOD = 12.0 * 86400.0          # one revolution in 12 days
NSTEPS = 480                     # CFL ~0.3 at ne 6 (tests/test_advection.py)
JAX_PREFIX = {False: 10, True: 5}
F64_TOL = 1e-12


def _problem():
    """(cs, cfg, q0 [e, 1, 1, 4, 4], vu, vv [e, 1, 4, 4]) in f64 on the
    CPU: the bell of radius 0.5 at (0, 0) and the solid-body zonal wind of
    one revolution a PERIOD."""
    cs = build_cubed_sphere(NE, device="cpu")
    cfg = Config(nelem=cs.nelem, nlev=1, qsize=1)
    u0 = 2.0 * np.pi * CONSTANTS.rearth / PERIOD
    vu = torch.from_numpy((u0 * np.cos(cs.lat))[:, None])
    q0 = torch.from_numpy(cosine_bell(cs.sphere_xyz, radius=0.5)[:, None, None])
    return cs, cfg, q0, vu, torch.zeros_like(vu)


def _mass(cs, q):
    return float((cs.geometry.spheremp[:, None, None] * q).sum())


def _jax_prefix(cs, q0, vu, vv, dt, limit, nsteps):
    """The JAX package's step, ``nsteps`` times from q0, on its own cubed
    sphere (asserted equal to the port's)."""
    jcs = j_build(NE)
    assert np.array_equal(np.asarray(jcs.gdof), cs.gdof)
    assert np.array_equal(np.asarray(jcs.sphere_xyz), cs.sphere_xyz)
    jcfg = jt.Config(nelem=jcs.nelem, nlev=1, qsize=1)
    gdof = jnp.asarray(jcs.gdof)
    q = jnp.asarray(q0.numpy())
    ju, jv = jnp.asarray(vu.numpy()), jnp.asarray(vv.numpy())
    for _ in range(nsteps):
        q = j_ssprk3_tracer_step(q, ju, jv, jcs.geometry, jcfg, dt,
                                 gdof=gdof, ndof=jcs.ndof, limit=limit)
    return np.asarray(q)


def _run(limit):
    """The bell's run: (cs, q0, q after the run), the first JAX_PREFIX
    steps held against the JAX package's."""
    cs, cfg, q0, vu, vv = _problem()
    nsteps = NSTEPS // 2 if limit else NSTEPS
    dt = (PERIOD / 2 if limit else PERIOD) / nsteps
    prefix = JAX_PREFIX[limit]
    q = q0
    for i in range(nsteps):
        q = ssprk3_tracer_step(q, vu, vv, cs.geometry, cfg, dt, gdof=cs.gdof,
                               ndof=cs.ndof, limit=limit)
        if i + 1 == prefix:
            ref = _jax_prefix(cs, q0, vu, vv, dt, limit, prefix)
            err = np.max(np.abs(q.numpy() - ref)) / np.max(np.abs(ref))
            assert err < F64_TOL, f"{prefix} steps against JAX: {err}"
    return cs, q0, q


def test_torch_solid_body_rotation_full_revolution():
    cs, q0, q = _run(limit=False)
    qf = q.numpy()
    assert np.isfinite(qf).all()
    # tracer mass kept by the weak form and the DSS
    np.testing.assert_allclose(_mass(cs, q), _mass(cs, q0), rtol=1e-10)
    # the shape after a revolution: bounded spectral-element transport
    err = np.linalg.norm(qf - q0.numpy()) / np.linalg.norm(q0.numpy())
    assert err < 0.3, f"L2 transport error {err}"
    # the peak neither collapses nor blows up
    assert 0.6 < qf.max() < 1.2


def test_torch_solid_body_rotation_with_limiter():
    cs, q0, q = _run(limit=True)
    qf = q.numpy()
    np.testing.assert_allclose(_mass(cs, q), _mass(cs, q0), rtol=1e-10)
    # monotone: the projection after the limiter leaks only marginally
    assert qf.min() > -1e-3
    assert qf.max() < 1.0 + 1e-3


@pytest.mark.parametrize("limit", [False, True])
def test_torch_packed_tracer_levels_are_independent(limit):
    """The packed SSPRK3 tracer step (f32, the plain versions on the CPU)
    computes every level on its own: a step on a subset of the levels gives
    those rows of the full-height step bit for bit (what lets the card's
    long bell run hold its plain twins at a few levels)."""
    from tinman_sandbox_tpu_torch.dist import (
        make_structured_plan, rsp_lanes_2f, ssprk3_tracer_packed_t_plain)
    from tinman_sandbox_tpu_torch.kernels.dss import dss_structured_t_cuda
    from tinman_sandbox_tpu_torch.kernels.layout import (
        META_COLS, pack_meta_t)

    ne, nlev, levels = 2, 8, [0, 3, 7]
    cs = build_cubed_sphere(ne, dtype=torch.float32, device="cpu")
    g, plan = cs.geometry, make_structured_plan(cs.gdof, ne)
    gen = torch.Generator().manual_seed(5)
    e16 = cs.nelem * 16
    meta = pack_meta_t(g, torch.zeros_like(g.spheremp), torch.float32)
    rsp = torch.from_numpy(rsp_lanes_2f(g.spheremp, cs.gdof, cs.ndof))
    sph = meta[META_COLS.index("spheremp")]
    vu = 30.0 * (torch.rand(nlev, e16, generator=gen) - 0.5)
    vv = 30.0 * (torch.rand(nlev, e16, generator=gen) - 0.5)
    q = dss_structured_t_cuda(sph * torch.rand(nlev, e16, generator=gen),
                              plan, rsp)
    dvv = g.dvv.float().contiguous()
    step = lambda v, w, x, k: ssprk3_tracer_packed_t_plain(
        dvv, meta, v, w, x, plan, rsp, 1e4, k, limit=limit)
    full = step(vu, vv, q, nlev)
    part = step(vu[levels].contiguous(), vv[levels].contiguous(),
                q[levels].contiguous(), len(levels))
    assert torch.equal(part, full[levels])
    assert not torch.equal(full, q)
