"""Conservative vertical remap, the rsplit cadence's other half (counterpart
of ``tinman_sandbox_tpu/ops/remap.py``).

HOMME pairs vertically Lagrangian dynamics (rsplit>0) with a periodic
conservative remap of the state from the drifted Lagrangian levels back to
the reference hybrid levels. The formulation is the JAX package's: the dense
O(nlev^2) overlap of every target interface with every source cell, in a
cumulative-integral form that is conservative by construction.
Reconstruction: piecewise constant (``pcm``), piecewise linear with minmod
limiting (``plm``) or piecewise parabolic with Colella-Woodward
monotonisation (``ppm``).

The overlap is a [K+1, K, columns] temporary for every field (1.8 GB at
ne30 x 72 in f32), so the columns go through in chunks whose temporaries
stay under ``MAX_TEMP_BYTES``. Every sum runs over the levels of one column,
and the sum over source cells is a fixed pairwise tree of elementwise adds
(``_level_tree_sum``), so a chunk changes no bit of the result on any
device.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["MAX_TEMP_BYTES", "comp_sum", "remap_column", "remap_levels",
           "reference_dp", "vertical_remap"]

# the largest [K+1, K, columns] temporary a chunk may make
MAX_TEMP_BYTES = 256 * 2 ** 20


def comp_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Neumaier-compensated sum along ``axis`` (f32-safe). The reference's
    own discipline where sums matter is compensated summation
    (utils_mod.F90:10-33); the limiter's mass and headroom sums and the
    remap's column totals use it."""
    xm = torch.movedim(x, axis, 0)
    s = torch.zeros_like(xm[0])
    c = torch.zeros_like(xm[0])
    for v in xm:
        t = s + v
        c = c + torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
        s = t
    return s + c


def _match_column_total(dp_tgt: torch.Tensor, dp_src: torch.Tensor,
                        axis: int = -3) -> torch.Tensor:
    """Rescale ``dp_tgt`` so every column's total equals ``dp_src``'s, both
    totals by compensated summation over the level ``axis``. The hybrid-level
    reconstruction reproduces the Lagrangian column total only to f32
    rounding per layer, and that rounding is biased (a linear air-mass drift
    in long runs); one multiply per level removes it."""
    tot_src = comp_sum(dp_src, axis).unsqueeze(axis)
    tot_tgt = comp_sum(dp_tgt, axis).unsqueeze(axis)
    return dp_tgt * (tot_src / tot_tgt)


def _interfaces(dp: torch.Tensor) -> torch.Tensor:
    """[K, C] layer thicknesses -> [K+1, C] cumulative interfaces."""
    return torch.cat([torch.zeros_like(dp[:1]), torch.cumsum(dp, 0)], 0)


def _level_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of [K+1, K, C] by a fixed pairwise tree of
    elementwise adds: the order of every column's sum depends on K alone,
    not on C or on the device's reduction kernels."""
    while x.shape[1] > 1:
        n = x.shape[1]
        h = n // 2
        y = x[:, :h] + x[:, h:2 * h]
        x = torch.cat([y, x[:, 2 * h:]], 1) if n % 2 else y
    return x[:, 0]


def _remap_chunk(q, dp_src, dp_tgt, scheme: str):
    """``remap_levels`` on one chunk of columns: q, dp_src, dp_tgt [K, C]."""
    s = _interfaces(dp_src)                       # [K+1, C]
    t = _interfaces(dp_tgt)
    # overlap of the target prefix (0, t_j) with source cell k:
    # clip(t_j - s_k, 0, dp_k)
    tj = t[:, None, :]                            # [K+1, 1, C]
    sk = s[None, :-1, :]                          # [1, K, C]
    dpk = dp_src[None]                            # [1, K, C]
    x = torch.minimum(torch.clamp(tj - sk, min=0.0), dpk)   # [K+1, K, C]
    # FULL coverage of every source cell at the last target interface:
    # cumsum rounding can leave t_K a few ulps below s_K, which would
    # silently truncate the bottom source cell, a biased mass loss
    x[-1] = dp_src

    qk = q[None]
    contrib = qk * x                              # PCM term
    if scheme == "plm":
        # limited linear reconstruction in each source cell:
        # q(xi) = q_k + m_k * (xi - dp_k/2), xi in [0, dp_k]
        d_lo = q[1:] - q[:-1]
        h_mid = 0.5 * (dp_src[1:] + dp_src[:-1])
        g = d_lo / h_mid                          # centred slope estimates
        zero = torch.zeros_like(q[:1])
        g_lo = torch.cat([zero, g], 0)
        g_hi = torch.cat([g, zero], 0)
        # minmod: zero at extrema, the smaller magnitude otherwise
        m = torch.where(g_lo * g_hi > 0.0,
                        torch.sign(g_lo) * torch.minimum(g_lo.abs(),
                                                         g_hi.abs()),
                        torch.zeros_like(g_lo))
        # integral of m*(xi - dp/2) over [0, x] = m*(x^2/2 - x*dp/2)
        contrib = contrib + m[None] * (0.5 * x * x - 0.5 * x * dpk)
    elif scheme == "ppm":
        # cell-edge values by 4th-order interpolation (edge-replicated at the
        # column ends), then CW84 monotonisation
        pad2 = torch.cat([q[:1], q[:1], q, q[-1:], q[-1:]], 0)   # [K+4, C]
        qm1 = pad2[1:-2]                          # q_{i-1} for edges 0..K
        qp0 = pad2[2:-1]                          # q_i
        qm2 = pad2[:-3]                           # q_{i-2}
        qp1 = pad2[3:]                            # q_{i+1}
        edges = (7.0 / 12.0) * (qm1 + qp0) - (1.0 / 12.0) * (qm2 + qp1)
        # each edge between its adjacent cell means (monotone edges)
        edges = torch.minimum(torch.maximum(edges, torch.minimum(qm1, qp0)),
                              torch.maximum(qm1, qp0))
        a_l = edges[:-1]
        a_r = edges[1:]
        # monotonise (Colella & Woodward 1984)
        extremum = (a_r - q) * (q - a_l) <= 0.0
        a_l = torch.where(extremum, q, a_l)
        a_r = torch.where(extremum, q, a_r)
        da = a_r - a_l
        dev = q - 0.5 * (a_l + a_r)
        a_l = torch.where(da * dev > da * da / 6.0, 3.0 * q - 2.0 * a_r, a_l)
        a_r = torch.where(-(da * da) / 6.0 > da * dev, 3.0 * q - 2.0 * a_l,
                          a_r)
        da = a_r - a_l
        a6 = 6.0 * (q - 0.5 * (a_l + a_r))
        # integral of the parabola over [0, x] in the local fraction
        # xi = x/dp: dp * (aL*xi + da*xi^2/2 + a6*(xi^2/2 - xi^3/3))
        xi = x / dpk
        contrib = dpk * (a_l[None] * xi + da[None] * 0.5 * xi * xi
                         + a6[None] * (0.5 * xi * xi - xi * xi * xi / 3.0))
    elif scheme != "pcm":
        raise ValueError(f"unknown remap scheme {scheme!r}")

    integral = _level_tree_sum(contrib)           # I(t_j), [K+1, C]
    return torch.diff(integral, dim=0) / dp_tgt


def remap_levels(q: torch.Tensor, dp_src: torch.Tensor, dp_tgt: torch.Tensor,
                 scheme: str = "plm", chunk: int | None = None
                 ) -> torch.Tensor:
    """Conservatively remap cell averages ``q`` from layers ``dp_src`` to
    ``dp_tgt`` (equal column totals), levels on axis 0: [K, C] each, C
    columns (the packed [nlev, E16] rows are this shape). ``chunk`` columns
    go through at a time (default: as many as keep the [K+1, K, chunk]
    temporary under ``MAX_TEMP_BYTES``); the result does not depend on it."""
    if scheme not in ("pcm", "plm", "ppm"):
        raise ValueError(f"unknown remap scheme {scheme!r}")
    if not (q.shape == dp_src.shape == dp_tgt.shape) or q.dim() != 2:
        raise ValueError(f"remap: q, dp_src, dp_tgt must be equal [K, C], "
                         f"got {tuple(q.shape)}, {tuple(dp_src.shape)}, "
                         f"{tuple(dp_tgt.shape)}")
    k, ncol = q.shape
    if chunk is None:
        chunk = max(1, MAX_TEMP_BYTES // ((k + 1) * k * q.element_size()))
    if chunk >= ncol:
        return _remap_chunk(q, dp_src, dp_tgt, scheme)
    return torch.cat([_remap_chunk(q[:, c:c + chunk], dp_src[:, c:c + chunk],
                                   dp_tgt[:, c:c + chunk], scheme)
                      for c in range(0, ncol, chunk)], 1)


def remap_column(q: torch.Tensor, dp_src: torch.Tensor, dp_tgt: torch.Tensor,
                 scheme: str = "plm") -> torch.Tensor:
    """``remap_levels`` on fields [..., nlev, np, np] (the JAX signature):
    every (..., i, j) is one column."""
    lead, (k, ni, nj) = q.shape[:-3], q.shape[-3:]

    def cols(x):
        return torch.movedim(x, -3, 0).reshape(k, -1)

    out = remap_levels(cols(q), cols(dp_src), cols(dp_tgt), scheme)
    return torch.movedim(out.reshape(k, *lead, ni, nj), 0, -3).contiguous()


def reference_dp(hv, ps: torch.Tensor) -> torch.Tensor:
    """Reference-level thicknesses from the hybrid coordinate,
    dp_ref(k) = (A(k+1)-A(k))*ps0 + (B(k+1)-B(k))*ps (hybvcoord_mod.F90):
    ps [..., np, np] -> [..., nlev, np, np]."""
    da = torch.diff(hv.hyai)[:, None, None]
    db = torch.diff(hv.hybi)[:, None, None]
    return da * hv.ps0 + db * ps[..., None, :, :]


def vertical_remap(state, hv, cfg, scheme: str = "plm"):
    """Remap u, v, T (mass-weighted) and qdp of time level np1 from the
    Lagrangian dp3d back to the reference hybrid levels; qdp is read and
    written at level qn0. Conserves column momentum (u dp, v dp), T dp and
    tracer mass. Returns a new state; the input is not modified."""
    np1, qn0 = cfg.np1, cfg.qn0
    dp_src = state.dp3d[np1]
    # surface pressure implied by the Lagrangian column (p_top + sum dp);
    # the compensated level sum and the column-total renormalisation keep
    # the air mass exact per remap
    ptop = hv.hyai[0] * hv.ps0
    ps = ptop + comp_sum(dp_src, -3)
    dp_tgt = _match_column_total(reference_dp(hv, ps), dp_src)

    # remap_column treats fields as densities per unit dp, so the u, v, T
    # remaps conserve column momentum and T*dp, and the mixing-ratio remap
    # conserves tracer mass (q_new * dp_tgt sums to qdp's column total)
    def rmp(x):
        return remap_column(x, dp_src, dp_tgt, scheme=scheme)

    def put(x, level, value):
        out = x.clone()
        out[level] = value
        return out

    q = state.qdp[qn0] / dp_src[:, None]          # [nelem, qsize, nlev, .]
    q_new = torch.stack([rmp(q[:, i]) for i in range(q.shape[1])], 1)
    return dataclasses.replace(
        state,
        u=put(state.u, np1, rmp(state.u[np1])),
        v=put(state.v, np1, rmp(state.v[np1])),
        t=put(state.t, np1, rmp(state.t[np1])),
        dp3d=put(state.dp3d, np1, dp_tgt),
        qdp=put(state.qdp, qn0, q_new * dp_tgt[:, None]),
    )
