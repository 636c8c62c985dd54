"""The raw state of a run, made from ``--seed`` (the cubed sphere and the
hybrid levels come from ``reference/grid.py``). The program's set-up and
the reference receive the same arrays; each projects the raw state onto
the continuous space itself.

The raw state is seeded noise on an atmosphere at rest: winds u, v ~
U(-10, 10) m/s at every point, T ~ 300 + U(-1, 1) K, dp the hybrid
reference layers at ps0 times 1 + U(-0.01, 0.01), tracer masses dp times
mixing ratios ~ U(0, 0.01), surface geopotential ~ U(0, 1) m^2/s^2. It is
drawn in float32 on the device by a ``torch.Generator`` seeded with
``--seed``, one call a field: the same seed gives the same arrays on the
same device. The noise makes every step change every field by far more
than float32's rounding, and hyperviscosity damps it, so the chain stays
finite over any window (20,000 steps at dt 10 s to 100 s on the card).
"""
from __future__ import annotations

import torch


def draw(seed: int, nelem: int, nlev: int, qsize: int, levels: dict,
         device) -> dict:
    """The raw state, float32 on ``device``: u, v, T, dp [nelem, nlev, 4,
    4], q [nelem, qsize, nlev, 4, 4], phis [nelem, 4, 4]."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    field = (nelem, nlev, 4, 4)

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device=device) \
            .uniform_(lo, hi, generator=gen)

    ps0 = float(levels["ps0"])
    dp_ref = torch.as_tensor(
        (levels["hyai"][1:] - levels["hyai"][:-1]) * ps0
        + (levels["hybi"][1:] - levels["hybi"][:-1]) * ps0,
        dtype=torch.float32, device=device)[None, :, None, None]
    u = uniform(field, -10.0, 10.0)
    v = uniform(field, -10.0, 10.0)
    t = uniform(field, -1.0, 1.0).add_(300.0)
    dp = uniform(field, -0.01, 0.01).add_(1.0).mul_(dp_ref)
    q = uniform((nelem, qsize, nlev, 4, 4), 0.0, 0.01).mul_(dp[:, None])
    phis = uniform((nelem, 4, 4), 0.0, 1.0)
    return dict(u=u, v=v, T=t, dp=dp, q=q, phis=phis)
