"""Float64 oracle (counterpart of ``tinman_sandbox_tpu/ref``)."""
from .caar_ref import caar_ref

__all__ = ["caar_ref"]
