"""Compensated summation (counterpart of ``comp_sum`` of
``tinman_sandbox_tpu/ops/remap.py``; the vertical remap of that module is
not ported yet)."""
from __future__ import annotations

import torch

__all__ = ["comp_sum"]


def comp_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Neumaier-compensated sum along ``axis`` (f32-safe). The reference's
    own discipline where sums matter is compensated summation
    (utils_mod.F90:10-33); the limiter's mass and headroom sums use it."""
    xm = torch.movedim(x, axis, 0)
    s = torch.zeros_like(xm[0])
    c = torch.zeros_like(xm[0])
    for v in xm:
        t = s + v
        c = c + torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
        s = t
    return s + c
