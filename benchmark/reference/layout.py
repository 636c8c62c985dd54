"""The program's packed "t" layout, read by the reference to judge the
program's outputs: a field [nelem, K, 4, 4] is stored as [K, nelem*16]
with column e*16 + i*4 + j; the state stacks u, v, T, dp as row blocks of
nlev rows, the tracers tracer-major (row q*nlev + k)."""
from __future__ import annotations

import torch


def unpack(x: torch.Tensor, nelem: int) -> torch.Tensor:
    """[K, nelem*16] -> [nelem, K, 4, 4]."""
    k = x.shape[0]
    return x.reshape(k, nelem, 4, 4).movedim(0, 1).contiguous()


def unpack_state(s: torch.Tensor, nelem: int, nlev: int) -> dict:
    """The stacked [4*nlev, E16] state as u, v, T, dp fields."""
    return {name: unpack(s[i * nlev:(i + 1) * nlev], nelem)
            for i, name in enumerate(("u", "v", "T", "dp"))}


def unpack_tracers(q: torch.Tensor, nelem: int, nlev: int) -> torch.Tensor:
    """[ntracer*nlev, E16] -> [nelem, ntracer, nlev, 4, 4]."""
    nq = q.shape[0] // nlev
    return q.reshape(nq, nlev, nelem, 4, 4).permute(2, 0, 1, 3, 4) \
        .contiguous()
