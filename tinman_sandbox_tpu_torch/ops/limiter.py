"""Mass-conserving monotone tracer limiter in field form (counterpart of
``tinman_sandbox_tpu/ops/limiter.py``, the HOMME limiter8 analog).

Element-local: clamp the nodal values into prescribed bounds while
conserving the element's tracer mass sum(w*q), by proportional
redistribution into the remaining headroom, with compensated sums. A fixed
iteration count and an exact uniform fallback. This is the f64-capable
oracle; the packed step's kernel (``kernels/tracer_t.py``) runs another
formulation of the same limiter that agrees with it to ~2e-4 in f32.
"""
from __future__ import annotations

import torch

from .remap import comp_sum

__all__ = ["limit_tracer", "element_bounds"]


def _gll_sum(x: torch.Tensor) -> torch.Tensor:
    """Compensated sum over the 16 GLL nodes (last two axes), keepdims."""
    s = comp_sum(x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]), -1)
    return s[..., None, None]


def element_bounds(q: torch.Tensor):
    """Per-element(-level) min/max of the nodal values:
    [..., np, np] -> two tensors broadcastable against q."""
    return (torch.amin(q, dim=(-2, -1), keepdim=True),
            torch.amax(q, dim=(-2, -1), keepdim=True))


def limit_tracer(q, w, qmin, qmax, iters: int = 2):
    """Clamp q into [qmin, qmax] nodally while conserving sum(w*q) per
    element(-level). q, w: [..., np, np] (w broadcastable); bounds
    broadcastable. After ``iters`` clip-and-redistribute passes any residual
    (bounds infeasible for the mass) is spread uniformly by weight, so
    conservation is exact regardless. Pure."""
    w = torch.broadcast_to(w, q.shape)
    mass = _gll_sum(w * q)
    tiny = torch.finfo(q.dtype).tiny         # 1e-300 would underflow in f32
    for _ in range(iters):
        q = torch.minimum(torch.maximum(q, qmin), qmax)
        deficit = mass - _gll_sum(w * q)
        up_room = w * (qmax - q)             # mass that can still be added
        dn_room = w * (q - qmin)             # mass that can still be removed
        up_tot = _gll_sum(up_room)
        dn_tot = _gll_sum(dn_room)
        add = torch.where(
            deficit > 0,
            torch.minimum(deficit, up_tot) * up_room
            / up_tot.clamp(min=tiny),
            -torch.minimum(-deficit, dn_tot) * dn_room
            / dn_tot.clamp(min=tiny))
        q = q + add / w.clamp(min=tiny)
    # exact-conservation fallback: spread any residual uniformly by weight
    residual = mass - _gll_sum(w * q)
    return q + residual / _gll_sum(w)
