"""Packed "[K, E16]" layout of the CAAR kernel (counterpart of the
transposed-layout helpers of ``tinman_sandbox_tpu/kernels/layout.py``).

    field[e, k, i, j]  ->  packed[k, e*16 + (i*4+j)]

Levels are rows and the element-GLL points are columns, so on the card one
thread owns one column and neighbouring threads read neighbouring addresses
of a row. The 16 columns of one element are consecutive. Per-element 2D
metric terms pack into one [16, e*16] meta array (META_COLS order on rows).
"""
from __future__ import annotations

import torch

from ..config import NP, NPSQ

__all__ = ["META_COLS", "pack_field_t", "unpack_field_t", "pack_meta_t"]

# row order of the packed per-element meta array
META_COLS = (
    "dinv00", "dinv01", "dinv10", "dinv11",
    "d00", "d01", "d10", "d11",
    "metdet", "rmetdet", "fcor", "spheremp",
    "phis", "mp", "pad1", "pad2",
)


def pack_field_t(x: torch.Tensor) -> torch.Tensor:
    """[..., e, k, np, np] -> [..., k, e*16], contiguous."""
    *lead, e, k, ni, nj = x.shape
    assert ni == NP and nj == NP
    xt = torch.movedim(x, -3, -1)                      # [..., e, np, np, k]
    return xt.reshape(*lead, e * NPSQ, k).transpose(-1, -2).contiguous()


def unpack_field_t(x: torch.Tensor, nelem: int) -> torch.Tensor:
    """[..., k, e*16] -> [..., e, k, np, np], contiguous."""
    *lead, k, e16 = x.shape
    assert e16 == nelem * NPSQ
    xt = x.transpose(-1, -2).reshape(*lead, nelem, NP, NP, k)
    return torch.movedim(xt, -1, -3).contiguous()


def pack_meta_t(geom, phis, dtype=None) -> torch.Tensor:
    """Per-element metric terms + phis packed into [16, e*16] (META_COLS
    rows), on the geometry's device."""
    dtype = dtype or torch.float32
    e = geom.fcor.shape[0]
    cols = {
        "dinv00": geom.dinv[:, 0, 0], "dinv01": geom.dinv[:, 0, 1],
        "dinv10": geom.dinv[:, 1, 0], "dinv11": geom.dinv[:, 1, 1],
        "d00": geom.d[:, 0, 0], "d01": geom.d[:, 0, 1],
        "d10": geom.d[:, 1, 0], "d11": geom.d[:, 1, 1],
        "metdet": geom.metdet, "rmetdet": geom.rmetdet,
        "fcor": geom.fcor, "spheremp": geom.spheremp,
        "phis": phis, "mp": geom.mp,
    }
    zeros = torch.zeros(e * NPSQ, dtype=dtype, device=geom.fcor.device)
    return torch.stack([
        cols[name].to(dtype).reshape(e * NPSQ) if name in cols else zeros
        for name in META_COLS
    ])
