"""The cubed sphere and the assembled step (counterpart of
``tinman_sandbox_tpu/dist``; the single-card parts ported so far: the grid,
the segment-sum and structured DSS, and the CAAR + DSS, SSPRK3 and
hyperviscosity steps)."""
from .cubed_sphere import CubedSphere, build_cubed_sphere
from .dss import continuity_error_t, dss_project, dss_scaled, dss_sum, rsp_2f
from .step import caar_dss_step
from .step_t import (
    apply_hypervis_packed_t,
    apply_hypervis_packed_t_plain,
    apply_hypervis_t,
    caar_dss_structured_packed_t,
    caar_dss_structured_packed_t4,
    caar_dss_structured_packed_t4_plain,
    caar_dss_t,
    ssprk3_packed_t4,
    ssprk3_packed_t4_plain,
    ssprk3_t,
)
from .structured_dss import (
    StructuredDssPlan,
    apply_rsp_t,
    dss_structured_scaled_t,
    dss_structured_t,
    make_structured_plan,
    rsp_lanes_2f,
)

__all__ = [
    "CubedSphere",
    "build_cubed_sphere",
    "continuity_error_t",
    "dss_project",
    "dss_scaled",
    "dss_sum",
    "rsp_2f",
    "caar_dss_step",
    "caar_dss_structured_packed_t",
    "caar_dss_structured_packed_t4",
    "caar_dss_structured_packed_t4_plain",
    "caar_dss_t",
    "ssprk3_packed_t4",
    "ssprk3_packed_t4_plain",
    "ssprk3_t",
    "apply_hypervis_packed_t",
    "apply_hypervis_packed_t_plain",
    "apply_hypervis_t",
    "StructuredDssPlan",
    "apply_rsp_t",
    "dss_structured_scaled_t",
    "dss_structured_t",
    "make_structured_plan",
    "rsp_lanes_2f",
]
