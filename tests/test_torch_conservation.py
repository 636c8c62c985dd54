"""The port's structured DSS under repeated projection: the two-float
rspheremp against the one-float row (mirrors tests/test_conservation.py);
and the packed SSPRK3 tracer step's mass over many steps.

A continuous field projected again and again, c <- rsp * DSS(sph * c) in
f32, keeps its mass sum(sph * c) only up to the product fl(rsp) * S, whose
per-dof error (~1e-8, of a fixed sign) the one-float rspheremp adds at
every pass: a linear drift. The two-float pair (``rsp_lanes_2f``, hi + lo
rows) carries 1/S to ~2^-48 and leaves the unbiased rounding of storage.
Mass is measured in f64 over the f32 data.

Tolerances are the JAX test's: after 300 projections at ne 3, k 8 the
two-float drift d2 < 3e-7 and d2 < d1 / 5; the two rspheremp forms agree
to rtol 3e-7, atol 3e-6 on one pass. With the one-float row the port's DSS
adds and multiplies in the JAX kernel's order, so there it equals
``dss_structured_t_pallas`` in interpret mode bit for bit
(tests/test_torch_dss.py).

The two-float scale is ``fmaf(y, hi, y*lo)`` (``dist.dss.mul_2f``, as the
kernels): with y*hi and y*lo rounded on their own and then added, lo (~1e-8
of hi) is lost nearly everywhere, and at ne 3 the two-float drift came out
8x the one-float one (5.4e-9 against 6.4e-10).

The packed steps' last Shu-Osher pair sums to exactly 1
(``timeloop.rk.third_stage_weights``). Rounded on their own, the float32
1/3 and 2/3 sum to 1 + 2**-25: every step then adds 3e-8 of the tracer
mass, 1.5e-5 over one revolution of the ne 6 bell, 7e-5 at ne30. The test
runs a cosine bell 100 steps through the f32 packed step with each pair
and holds the port's drift under a fifth of the rounded pair's, which
shows that bias."""
from fractions import Fraction
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.kernels.dss_pallas import dss_structured_t_pallas
from tinman_sandbox_tpu_torch import CONSTANTS
from tinman_sandbox_tpu_torch.dist import (
    build_cubed_sphere,
    cosine_bell,
    dss_structured_scaled_t,
    make_structured_plan,
    rsp_lanes_2f,
    ssprk3_tracer_packed_t,
    step_t,
)
from tinman_sandbox_tpu_torch.kernels.dss import dss_structured_t_cuda
from tinman_sandbox_tpu_torch.kernels.layout import (
    META_COLS,
    pack_field_t,
    pack_meta_t,
)
from tinman_sandbox_tpu_torch.timeloop.rk import third_stage_weights

torch.set_num_threads(2)

# the plain structured DSS (dist/structured_dss.py) and the DSS kernels'
# wrappers on CPU tensors, which run their plain versions (extract, fixup,
# sweep): the path the card's projections take
FORMS = {"structured": dss_structured_scaled_t,
         "kernel_plain": dss_structured_t_cuda}


def _rsps(cs):
    """(one-float [1, E16], two-float [2, E16]) rspheremp rows, f32."""
    g = cs.geometry
    rsp1 = g.rspheremp.to(torch.float32).reshape(1, -1).contiguous()
    rsp2 = torch.from_numpy(rsp_lanes_2f(g.spheremp, cs.gdof, cs.ndof))
    return rsp1, rsp2


def _project_loop(dss, rsp, sph, x0, plan, iters):
    """The relative mass drift of ``iters`` projections c <- rsp*DSS(sph*c)
    in f32 from the projected x0 (sph the f32 spheremp row), the mass
    sum(sph * c) in f64."""
    def once(c):
        return dss((sph * c).contiguous(), plan, rsp)

    mass = lambda c: float((sph.double() * c.double()).sum())
    c = once(x0.to(torch.float32))                 # start continuous
    m0 = mass(c)
    for _ in range(iters):
        c = once(c)
    return abs(mass(c) - m0) / abs(m0)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_torch_two_float_rsp_kills_dss_mass_bias(form):
    ne, k, iters = 3, 8, 300
    cs = build_cubed_sphere(ne, device="cpu")
    plan = make_structured_plan(cs.gdof, ne)
    sph = cs.geometry.spheremp.to(torch.float32).reshape(1, -1)
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(np.abs(rng.standard_normal((k, cs.nelem * 16)))
                          + 1.0)
    rsp1, rsp2 = _rsps(cs)
    d1 = _project_loop(FORMS[form], rsp1, sph, x0, plan, iters)
    d2 = _project_loop(FORMS[form], rsp2, sph, x0, plan, iters)
    # one-float: the fixed bias integrates ~linearly (~1e-8 a pass);
    # two-float: a random walk at the storage-rounding envelope
    assert d2 < 3e-7, (d1, d2)
    assert d2 < d1 / 5, (d1, d2)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_torch_two_float_rsp_matches_one_float_dss(form):
    """The two-float pass agrees with the one-float pass to f32 tolerance
    (the same sums, a better-conditioned scale), and the one-float pass
    equals the JAX package's DSS kernel (interpret mode) bit for bit."""
    ne, k = 2, 6
    jcs = j_build(ne)
    cs = build_cubed_sphere(ne, device="cpu")
    plan = make_structured_plan(cs.gdof, ne)
    assert np.array_equal(np.asarray(jcs.gdof), np.asarray(cs.gdof))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((k, cs.nelem * 16)).astype(np.float32)
    rsp1, rsp2 = _rsps(cs)
    a = FORMS[form](torch.from_numpy(x), plan, rsp1)
    b = FORMS[form](torch.from_numpy(x), plan, rsp2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-7, atol=3e-6)
    ref = dss_structured_t_pallas(jnp.asarray(x), j_plan(jcs.gdof, ne),
                                  jnp.asarray(rsp1.numpy()), interpret=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref))


@pytest.mark.parametrize("f", [np.float32, np.float64])
def test_torch_third_stage_pair_sums_to_one(f):
    a, b = third_stage_weights(f)
    assert type(a) is f and type(b) is f
    assert Fraction(float(a)) + Fraction(float(b)) == 1
    assert b == f(2.0 / 3.0)
    assert abs(float(a) - 1.0 / 3.0) <= float(np.spacing(f(1.0 / 3.0)))
    # the pair rounded on its own: 1 + 2**-25 in float32, 1 - 2**-54 in f64
    rounded = Fraction(float(f(1.0 / 3.0))) + Fraction(float(f(2.0 / 3.0)))
    assert rounded == (1 + Fraction(1, 2 ** 25) if f is np.float32
                       else 1 - Fraction(1, 2 ** 54))


def test_torch_packed_tracer_mass_has_no_coefficient_bias():
    """A cosine bell (radius 0.5 rad) carried 100 steps by solid-body winds
    through the f32 packed SSPRK3 tracer step at ne 3 (the CFL of
    tests/test_advection.py): the relative mass drift with the port's pair
    under a fifth of that with f(1/3), f(2/3), which drifts by its
    2**-25 a step."""
    ne, steps, period = 3, 100, 12.0 * 86400.0
    cs = build_cubed_sphere(ne, dtype=torch.float32, device="cpu")
    plan = make_structured_plan(cs.gdof, ne)
    g = cs.geometry
    dt = period / (80 * ne)
    u0 = 2.0 * np.pi * CONSTANTS.rearth / period
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).float()
    vu = pack_field_t(f32((u0 * np.cos(cs.lat))[:, None]))
    meta = pack_meta_t(g, torch.zeros_like(g.spheremp), torch.float32)
    dvv = g.dvv.float().contiguous()
    rsp = torch.from_numpy(rsp_lanes_2f(g.spheremp, cs.gdof, cs.ndof))
    sph = meta[META_COLS.index("spheremp")]
    bell = pack_field_t(f32(cosine_bell(cs.sphere_xyz, radius=0.5)[:, None]))
    q0 = dss_structured_t_cuda((sph * bell).contiguous(), plan, rsp)
    mass = lambda q: float((sph.double() * q.double()).sum())

    def drift():
        q = q0
        for _ in range(steps):
            q = ssprk3_tracer_packed_t(dvv, meta, vu, torch.zeros_like(vu), q,
                                       plan, rsp, dt, 1)
        return mass(q) / mass(q0) - 1.0

    port = drift()
    with mock.patch.object(step_t, "third_stage_weights",
                           lambda f: (f(1.0 / 3.0), f(2.0 / 3.0))):
        rounded = drift()
    assert rounded > 0.5 * steps * 2.0 ** -25, rounded
    assert abs(port) < abs(rounded) / 5, (port, rounded)
