"""Batched operators (counterpart of ``tinman_sandbox_tpu/ops``)."""
from .limiter import element_bounds, limit_tracer
from .remap import comp_sum
from .scans import (
    eta_dot_dpdn_rsplit0,
    midpoint_pressure,
    preq_hydrostatic,
    preq_omega_ps,
    preq_vertadv,
)
from .sphere import (
    curl_sphere_wk_testcov,
    divergence_sphere,
    divergence_sphere_update,
    divergence_sphere_wk,
    grad_sphere_wk_testcov,
    gradient_sphere,
    gradient_sphere_update,
    laplace_simple,
    laplace_tensor,
    laplace_tensor_replace,
    vlaplace_sphere_wk_cartesian,
    vlaplace_sphere_wk_cartesian_reduced,
    vlaplace_sphere_wk_contra,
    vorticity_sphere,
    vorticity_sphere_vector,
)
from .thermo import virtual_temperature

__all__ = [
    "comp_sum",
    "curl_sphere_wk_testcov",
    "divergence_sphere",
    "divergence_sphere_update",
    "divergence_sphere_wk",
    "element_bounds",
    "eta_dot_dpdn_rsplit0",
    "grad_sphere_wk_testcov",
    "gradient_sphere",
    "gradient_sphere_update",
    "laplace_simple",
    "laplace_tensor",
    "laplace_tensor_replace",
    "limit_tracer",
    "midpoint_pressure",
    "preq_hydrostatic",
    "preq_omega_ps",
    "preq_vertadv",
    "virtual_temperature",
    "vlaplace_sphere_wk_cartesian",
    "vlaplace_sphere_wk_cartesian_reduced",
    "vlaplace_sphere_wk_contra",
    "vorticity_sphere",
    "vorticity_sphere_vector",
]
