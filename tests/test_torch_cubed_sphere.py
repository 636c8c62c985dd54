"""The port's cubed sphere, DSS plan and segment-sum DSS against the JAX
package's on the same grids (ne = 2 and 3)."""
import dataclasses

import numpy as np
import pytest
import torch

from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu_torch.convert import cubed_sphere_from_numpy, plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    build_cubed_sphere,
    dss_project,
    dss_scaled,
    dss_sum,
    make_structured_plan,
)

torch.set_num_threads(2)
GEOM_FIELDS = ("dvv", "fcor", "metdet", "rmetdet", "spheremp", "rspheremp",
               "d", "dinv", "mp", "metinv", "vec_sph2cart")


@pytest.mark.parametrize("ne", [2, 3])
def test_torch_cubed_sphere_matches_jax_bitwise(ne):
    """Same numpy arithmetic: geometry, gdof, ndof and multiplicity equal
    bit for bit (f64)."""
    jcs, cs = j_build(ne), build_cubed_sphere(ne, device="cpu")
    assert (cs.ne, cs.nelem, cs.ndof) == (jcs.ne, jcs.nelem, jcs.ndof)
    for name in ("gdof", "multiplicity", "sphere_xyz", "lat", "lon"):
        np.testing.assert_array_equal(getattr(cs, name), getattr(jcs, name),
                                      err_msg=name)
    for name in GEOM_FIELDS:
        got = getattr(cs.geometry, name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jcs.geometry, name)),
                                      err_msg=name)


@pytest.mark.parametrize("ne", [2, 3])
def test_torch_structured_plan_matches_jax(ne):
    jcs = j_build(ne)
    jp = j_plan(jcs.gdof, ne)
    p = make_structured_plan(build_cubed_sphere(ne, device="cpu").gdof, ne)
    assert p.ne == jp.ne
    assert p.edges == jp.edges
    assert p.corner_rows == jp.corner_rows
    assert sum(e[4] for e in p.edges) == 4          # four flipped cube edges


def test_torch_structured_plan_rejects_wrong_ordering():
    bad = build_cubed_sphere(2, device="cpu").gdof.copy()
    bad[[0, 5]] = bad[[5, 0]]
    with pytest.raises(AssertionError):
        make_structured_plan(bad, 2)


def test_torch_dss_project_identity_f64():
    """dss_project(x) == x for continuous x (a function of the dof), f64."""
    cs = build_cubed_sphere(3, device="cpu")
    g = cs.geometry
    dof = torch.from_numpy(cs.gdof.astype(np.float64))[:, None]
    lev = torch.arange(5, dtype=torch.float64)[None, :, None, None]
    x = torch.sin(1e-2 * dof * (lev + 1.0)) + lev          # [nelem, 5, 4, 4]
    got = dss_project(x, cs.gdof, cs.ndof, g.spheremp, g.rspheremp)
    assert float((got - x).abs().max()) < 1e-13
    # and a discontinuous x is made continuous: every alias of a dof agrees
    rng = np.random.default_rng(4)
    y = dss_project(torch.from_numpy(rng.standard_normal(x.shape)), cs.gdof,
                    cs.ndof, g.spheremp, g.rspheremp)
    flat = y.permute(0, 2, 3, 1).reshape(-1, 5)
    first = np.unique(cs.gdof.reshape(-1), return_index=True)[1]
    canon = torch.from_numpy(first[cs.gdof.reshape(-1)])
    assert torch.equal(flat, flat[canon])


@pytest.mark.parametrize("two_float", [False, True])
def test_torch_dss_scaled_matches_jax(two_float):
    """The segment-sum DSS against the JAX package's dss_scaled, with the
    single and the two-float rspheremp. f64 at 1e-13 scaled: the segment
    sums add the aliases in another order."""
    import jax.numpy as jnp

    from tinman_sandbox_tpu.dist.dss import dss_scaled as j_dss_scaled
    from tinman_sandbox_tpu.dist.dss import rsp_2f as j_rsp_2f
    from tinman_sandbox_tpu_torch.dist import rsp_2f

    jcs = j_build(2)
    cs = build_cubed_sphere(2, device="cpu")
    x = np.random.default_rng(5).standard_normal((cs.nelem, 3, 4, 4))
    g = jcs.geometry
    if two_float:
        jr = j_rsp_2f(g.spheremp, jcs.gdof, jcs.ndof)
        tr = rsp_2f(cs.geometry.spheremp, cs.gdof, cs.ndof)
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a, b)
        jr = tuple(jnp.asarray(r, jnp.float64) for r in jr)
        tr = tuple(torch.from_numpy(r.astype(np.float64)) for r in tr)
    else:
        jr, tr = jnp.asarray(g.rspheremp), cs.geometry.rspheremp
    ref = np.asarray(j_dss_scaled(jnp.asarray(x), jnp.asarray(jcs.gdof),
                                  jcs.ndof, jr))
    got = dss_scaled(torch.from_numpy(x), cs.gdof, cs.ndof, tr).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-13
    raw = dss_sum(torch.from_numpy(x), torch.from_numpy(cs.gdof), cs.ndof)
    assert raw.shape == x.shape


def test_torch_convert_cubed_sphere_round_trip():
    """A JAX cubed sphere and plan handed over as numpy: the port's objects
    hold the same arrays, and the port plan from the handed-over gdof equals
    the handed-over plan."""
    jcs = j_build(2)
    jp = j_plan(jcs.gdof, 2)
    mesh = {f.name: getattr(jcs, f.name) for f in dataclasses.fields(jcs)
            if f.name != "geometry"}
    geom = {f.name: np.asarray(getattr(jcs.geometry, f.name))
            for f in dataclasses.fields(jcs.geometry)}
    cs = cubed_sphere_from_numpy(mesh, geom, dtype=torch.float32,
                                 device="cpu")
    assert (cs.ne, cs.nelem, cs.ndof) == (2, 24, jcs.ndof)
    np.testing.assert_array_equal(cs.gdof, jcs.gdof)
    for name in GEOM_FIELDS:
        got = getattr(cs.geometry, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jcs.geometry, name), np.float32))
    plan = plan_from_fields(jp.ne, jp.edges, jp.corner_rows)
    assert plan == make_structured_plan(cs.gdof, 2)
    assert hash(plan) == hash(make_structured_plan(cs.gdof, 2))
