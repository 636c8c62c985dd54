"""Device selection shared by every entry point, and the tensor-dataclass
mixin that ``State``, ``Derived``, ``Geometry`` and ``HybridVCoord`` use.

Entry points run on the card unless the caller asks for the CPU. A request
for CUDA on a machine without a card raises; nothing carries on quietly on
the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["resolve_device", "TensorFields", "from_arrays"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class TensorFields:
    """Mixin for dataclasses whose fields are tensors (other fields, such as
    ``HybridVCoord.ps0``, pass through unchanged)."""

    def to(self, device=None, dtype=None):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def from_arrays(cls, arrays: dict, dtype=None, device="cuda"):
    """``cls`` built from numpy arrays (each cast to ``dtype``, else kept in
    its own) on ``device``; 0-d values become Python floats."""
    dev = resolve_device(device)
    out = {}
    for name, value in arrays.items():
        if np.ndim(value) == 0:
            out[name] = float(value)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value))
            out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return cls(**out)
