"""The rest of the structured DSS: the roll-sweep form on the transposed
layout (``dss_structured_t_roll``) and the field-layout wrappers
(``dss_scaled_structured_field``, ``dss_project_structured_field``), each
bit for bit the JAX package's on the same numpy inputs, f32 and f64, at
ne = 2 and 3 (an odd ne too).

The projection's JAX function is held bit for bit as JAX runs it op by op
(``jax.disable_jit``). Jitted, XLA on the CPU contracts a product spheremp*x
and the DSS sum it feeds into one fused multiply-add, which moves a few
entries by one ulp: against the jitted function the tolerance is 2 ulps of
the dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.structured_dss import (
    dss_project_structured_field as j_project_field,
    dss_scaled_structured_field as j_scaled_field,
    dss_structured_t_roll as j_roll,
    make_structured_plan as j_plan,
)
from tinman_sandbox_tpu_torch.convert import plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    continuity_error_t,
    dss_project,
    dss_project_structured_field,
    dss_scaled_structured_field,
    dss_structured_t,
    dss_structured_t_roll,
)

torch.set_num_threads(2)
DTYPES = [np.float32, np.float64]


def _plans(ne):
    jcs = j_build(ne)
    jp = j_plan(jcs.gdof, ne)
    return jcs, jp, plan_from_fields(jp.ne, jp.edges, jp.corner_rows)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ne", [2, 3])
def test_torch_dss_roll_matches_jax(ne, dtype):
    jcs, jp, plan = _plans(ne)
    x = np.random.default_rng(ne).normal(size=(5, 6 * ne * ne * 16)) \
        .astype(dtype)
    want = np.asarray(j_roll(jnp.asarray(x), jp))
    got = dss_structured_t_roll(torch.from_numpy(x), plan)
    assert got.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, dss_structured_t(torch.from_numpy(x), plan))
    assert continuity_error_t(got, jcs.gdof) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ne,mid", [(2, (3,)), (3, (2, 4))])
def test_torch_dss_field_wrappers_match_jax(ne, mid, dtype):
    jcs, jp, plan = _plans(ne)
    g = jcs.geometry
    rng = np.random.default_rng(10 + ne)
    x = rng.normal(size=(jcs.nelem, *mid, 4, 4)).astype(dtype)
    sph, rsp = np.asarray(g.spheremp), np.asarray(g.rspheremp)
    want = np.asarray(j_scaled_field(jnp.asarray(x), jp, jnp.asarray(rsp)))
    got = dss_scaled_structured_field(torch.from_numpy(x), plan,
                                      torch.from_numpy(rsp))
    assert got.shape == x.shape and np.array_equal(got.numpy(), want)
    args = (jnp.asarray(x), jp, jnp.asarray(sph), jnp.asarray(rsp))
    with jax.disable_jit():
        want = np.asarray(j_project_field.__wrapped__(*args))
    got = dss_project_structured_field(torch.from_numpy(x), plan,
                                       torch.from_numpy(sph),
                                       torch.from_numpy(rsp))
    assert np.array_equal(got.numpy(), want)
    fused = np.asarray(j_project_field(*args))
    ulp = np.finfo(dtype).eps
    np.testing.assert_allclose(got.numpy(), fused, rtol=2 * ulp,
                               atol=2 * ulp * float(np.abs(fused).max()))
    # the drop-in for the segment-sum projection, to rounding
    ref = dss_project(torch.from_numpy(x).double(), jcs.gdof, jcs.ndof,
                      torch.from_numpy(sph).double(),
                      torch.from_numpy(rsp).double())
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=tol,
                               atol=tol * float(ref.abs().max()))
