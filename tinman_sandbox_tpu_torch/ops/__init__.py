"""Batched operators (counterpart of ``tinman_sandbox_tpu/ops``)."""
from .scans import midpoint_pressure, preq_hydrostatic, preq_omega_ps
from .sphere import divergence_sphere, gradient_sphere, vorticity_sphere
from .thermo import virtual_temperature

__all__ = [
    "divergence_sphere",
    "gradient_sphere",
    "midpoint_pressure",
    "preq_hydrostatic",
    "preq_omega_ps",
    "virtual_temperature",
    "vorticity_sphere",
]
