"""Batched operators (counterpart of ``tinman_sandbox_tpu/ops``)."""
from .diagnostics import (
    energy_diagnostics,
    energy_diagnostics_packed_t,
    global_integral,
)
from .limiter import element_bounds, limit_tracer
from .remap import (
    comp_sum,
    reference_dp,
    remap_column,
    remap_levels,
    vertical_remap,
)
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
    "energy_diagnostics",
    "energy_diagnostics_packed_t",
    "eta_dot_dpdn_rsplit0",
    "global_integral",
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
    "reference_dp",
    "remap_column",
    "remap_levels",
    "virtual_temperature",
    "vlaplace_sphere_wk_cartesian",
    "vlaplace_sphere_wk_cartesian_reduced",
    "vlaplace_sphere_wk_contra",
    "vorticity_sphere",
    "vertical_remap",
    "vorticity_sphere_vector",
]
