"""Structured (gather-free) DSS on the contiguous cubed-sphere ordering
(counterpart of the row- and transposed-layout parts of
``tinman_sandbox_tpu/dist/structured_dss.py``).

With elements ordered face-major / row-major and GLL points packed as
``lane = e*16 + i*4 + j`` (``kernels/layout.py``), a [k, e16] field reshapes
to ``x[k, face, ej, ei, i, j]`` and DSS decomposes into

  1. an alpha sweep: sum the shared i=3 / i=0 columns of ei-neighbours;
  2. a beta sweep on the result: sum the shared j=3 / j=0 columns of
     ej-neighbours (the in-face 4-way element corners come out right);
  3. twelve cube-edge line exchanges: each cube edge joins two face sides
     whose GLL lines match identically or reversed (resolved at plan build
     from the gdof map), line endpoints (cube corners) excluded;
  4. an 8-corner fix: each cube corner dof has three aliasing lanes, summed
     from the pre-sweep values.

``dss_structured_t`` is the plain version of this algebra in PyTorch; the
CUDA kernels of ``kernels/dss.py`` compute the same function.
``dss_structured_t_roll`` does the two sweeps as masked lane rolls, and
``dss_scaled_structured_field`` / ``dss_project_structured_field`` run the
row-layout DSS on [nelem, *mid, np, np] fields.
``dss_structured`` and ``dss_structured_scaled`` are the same sums on the
row layout [e16, k] (one row per lane): the JAX package computes them as XLA
array code, and so do these, with the same additions in the same order
(bit for bit its results).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import NP, NPSQ
from .dss import mul_2f

__all__ = ["StructuredDssPlan", "make_structured_plan", "dss_structured",
           "dss_structured_scaled", "dss_structured_t",
           "dss_structured_t_roll", "dss_structured_scaled_t",
           "dss_scaled_structured_field", "dss_project_structured_field",
           "apply_rsp_t", "rsp_lanes_2f"]

_SIDES = ("W", "E", "S", "N")


def _side_line_idx(ne: int, face: int, side: str) -> np.ndarray:
    """Flat packed lane indices of a face side's GLL line, ordered along the
    edge ([ne*4] ints). Lane = ((face*ne + ej)*ne + ei)*16 + i*4 + j."""
    run = np.repeat(np.arange(ne), NP)          # element index along the side
    pos = np.tile(np.arange(NP), ne)            # GLL index along the side
    if side in ("W", "E"):
        ei = 0 if side == "W" else ne - 1
        i = 0 if side == "W" else NP - 1
        return ((face * ne + run) * ne + ei) * NPSQ + i * NP + pos
    ej = 0 if side == "S" else ne - 1
    j = 0 if side == "S" else NP - 1
    return ((face * ne + ej) * ne + run) * NPSQ + pos * NP + j


@dataclasses.dataclass(frozen=True)
class StructuredDssPlan:
    """Static orientation descriptors for one cubed-sphere resolution
    (hashable, so tables derived from it can be cached per plan)."""

    ne: int
    # 12 entries: (face_a, side_a, face_b, side_b, flip)
    edges: Tuple[Tuple[int, str, int, str, bool], ...]
    # [8, 3] packed lane indices of each cube corner's three aliases
    corner_rows: Tuple[Tuple[int, int, int], ...]


def make_structured_plan(gdof, ne: int) -> StructuredDssPlan:
    """Derive the cube-edge pairing / orientation and the corner aliases
    numerically from the global dof map (no hand-coded face table)."""
    g = np.asarray(gdof).reshape(-1)
    lines = {(f, s): _side_line_idx(ne, f, s) for f in range(6) for s in _SIDES}

    # the two in-face sweeps must see matching dofs
    g6 = np.asarray(gdof).reshape(6, ne, ne, NP, NP)
    if not np.array_equal(g6[:, :, :-1, NP - 1, :], g6[:, :, 1:, 0, :]):
        raise AssertionError("alpha-neighbour dofs misaligned: the packed "
                             "ordering changed?")
    if not np.array_equal(g6[:, :-1, :, :, NP - 1], g6[:, 1:, :, :, 0]):
        raise AssertionError("beta-neighbour dofs misaligned: the packed "
                             "ordering changed?")

    keys = list(lines)
    used = set()
    edges = []
    for a_i, ka in enumerate(keys):
        if ka in used:
            continue
        ga = g[lines[ka]]
        for kb in keys[a_i + 1:]:
            if kb in used:
                continue
            gb = g[lines[kb]]
            if np.array_equal(ga, gb):
                edges.append((ka[0], ka[1], kb[0], kb[1], False))
            elif np.array_equal(ga, gb[::-1]):
                edges.append((ka[0], ka[1], kb[0], kb[1], True))
            else:
                continue
            used.add(ka)
            used.add(kb)
            break
    if len(edges) != 12:
        raise AssertionError(f"expected 12 cube edges, found {len(edges)}")

    rows_of = {}
    for r, d in enumerate(g.tolist()):
        rows_of.setdefault(d, []).append(r)
    corners = sorted(rs for rs in rows_of.values() if len(rs) == 3)
    if len(corners) != 8:
        raise AssertionError(f"expected 8 cube corners, found {len(corners)}")
    return StructuredDssPlan(ne=ne, edges=tuple(edges),
                             corner_rows=tuple(tuple(rs) for rs in corners))


def _line_view(x6: torch.Tensor, ne: int, face: int, side: str):
    """A face side's GLL line as a [k, ne, np] view of the
    [k, 6, ne, ne, np, np] field (ordering as ``_side_line_idx``)."""
    if side == "W":
        return x6[:, face, :, 0, 0, :]
    if side == "E":
        return x6[:, face, :, ne - 1, NP - 1, :]
    if side == "S":
        return x6[:, face, 0, :, :, 0]
    return x6[:, face, ne - 1, :, :, NP - 1]


def _check_lanes(x: torch.Tensor, plan: StructuredDssPlan):
    if x.shape[1] != 6 * plan.ne * plan.ne * NPSQ:
        raise ValueError(f"dss: e16={x.shape[1]} does not match ne={plan.ne}")


def _edges_and_corners(x: torch.Tensor, x6: torch.Tensor,
                       plan: StructuredDssPlan) -> torch.Tensor:
    """Steps 3 and 4 of the DSS on the swept [k, 6, ne, ne, np, np] field
    ``x6`` (updated in place); ``x`` is the field before the sweeps."""
    ne = plan.ne
    k, e16 = x.shape

    # 3. cube-edge line exchanges (interiors; endpoints are cube corners)
    for fa, sa, fb, sb, flip in plan.edges:
        la = _line_view(x6, ne, fa, sa).reshape(k, ne * NP)
        lb = _line_view(x6, ne, fb, sb).reshape(k, ne * NP)
        s = la + (torch.flip(lb, (1,)) if flip else lb)
        sb_new = torch.flip(s, (1,)) if flip else s
        _line_view(x6, ne, fa, sa).copy_(
            torch.cat([la[:, :1], s[:, 1:-1], la[:, -1:]], 1).reshape(k, ne, NP))
        _line_view(x6, ne, fb, sb).copy_(
            torch.cat([lb[:, :1], sb_new[:, 1:-1], lb[:, -1:]], 1)
            .reshape(k, ne, NP))

    # 4. cube corners, from the pre-sweep values
    flat = x6.reshape(k, e16)
    rows = torch.as_tensor(np.asarray(plan.corner_rows), device=x.device)
    vals = x[:, rows[:, 0]] + x[:, rows[:, 1]] + x[:, rows[:, 2]]   # [k, 8]
    for c in range(3):
        flat[:, rows[:, c]] = vals
    return flat


def dss_structured_t(x: torch.Tensor, plan: StructuredDssPlan) -> torch.Tensor:
    """DSS (unscaled shared-dof sum) of a transposed [k, e16] field."""
    _check_lanes(x, plan)
    ne = plan.ne
    x6 = x.reshape(x.shape[0], 6, ne, ne, NP, NP).clone()

    # 1. alpha sweep (ei-neighbours share the i=3 / i=0 GLL columns)
    t = x6[:, :, :, :-1, NP - 1, :] + x6[:, :, :, 1:, 0, :]
    x6[:, :, :, :-1, NP - 1, :] = t
    x6[:, :, :, 1:, 0, :] = t

    # 2. beta sweep on the result
    t = x6[:, :, :-1, :, :, NP - 1] + x6[:, :, 1:, :, :, 0]
    x6[:, :, :-1, :, :, NP - 1] = t
    x6[:, :, 1:, :, :, 0] = t
    return _edges_and_corners(x, x6, plan)


def _sweep_masks_t(ne: int, e16: int, device):
    """0/1 lane masks of the in-face shared GLL columns, for the roll
    sweeps (lane = ((f*ne + ej)*ne + ei)*16 + i*4 + j), in float32 as the
    JAX package's."""
    lane = torch.arange(e16, device=device)[None, :]
    i = (lane // NP) % NP
    j = lane % NP
    ei = (lane // NPSQ) % ne
    ej = (lane // (NPSQ * ne)) % ne
    f32 = torch.float32
    return (((i == NP - 1) & (ei < ne - 1)).to(f32),    # partner +4 lanes
            ((i == 0) & (ei > 0)).to(f32),              # partner -4 lanes
            ((j == NP - 1) & (ej < ne - 1)).to(f32),    # +(16*ne - 3)
            ((j == 0) & (ej > 0)).to(f32))              # -(16*ne - 3)


def dss_structured_t_roll(x: torch.Tensor,
                          plan: StructuredDssPlan) -> torch.Tensor:
    """``dss_structured_t`` with the alpha and beta sweeps as masked cyclic
    lane shifts (the in-face alpha partner of a lane is 4 lanes away, the
    beta partner 16*ne - 3), then the same edge lines and cube corners
    (counterpart of ``dss_structured_t_roll``; bit for bit its results)."""
    _check_lanes(x, plan)
    ne = plan.ne
    k, e16 = x.shape
    m_a_hi, m_a_lo, m_b_hi, m_b_lo = _sweep_masks_t(ne, e16, x.device)
    y = (x + m_a_hi * torch.roll(x, -NP, 1)) + m_a_lo * torch.roll(x, NP, 1)
    db = NPSQ * ne - (NP - 1)
    z = (y + m_b_hi * torch.roll(y, -db, 1)) + m_b_lo * torch.roll(y, db, 1)
    return _edges_and_corners(x, z.reshape(k, 6, ne, ne, NP, NP), plan)


def dss_structured(x: torch.Tensor, plan: StructuredDssPlan) -> torch.Tensor:
    """DSS (unscaled shared-dof sum) of a row-layout [e16, k] field."""
    return dss_structured_t(x.T, plan).T.contiguous()


def dss_structured_scaled(x: torch.Tensor, plan: StructuredDssPlan,
                          rsp_rows: torch.Tensor) -> torch.Tensor:
    """rspheremp * DSS(x) for row-layout [e16, k] fields; ``rsp_rows`` is
    [e16, 1]."""
    return rsp_rows * dss_structured(x, plan)


def _to_packed_cols(x: torch.Tensor):
    """[nelem, *mid, np, np] -> ([nelem*16, M], mid) in packed row order."""
    ne, mid = x.shape[0], x.shape[1:-2]
    cols = torch.movedim(x.reshape(ne, -1, NP, NP), 1, 3)   # [ne, np, np, M]
    return cols.reshape(ne * NPSQ, -1), mid


def _from_packed_cols(cols: torch.Tensor, ne: int, mid) -> torch.Tensor:
    x = torch.movedim(cols.reshape(ne, NP, NP, -1), 3, 1)
    return x.reshape(ne, *mid, NP, NP).contiguous()


def _rows(per_elem: torch.Tensor) -> torch.Tensor:
    """[nelem, np, np] -> [nelem*16, 1]."""
    return per_elem.reshape(-1, 1)


def dss_scaled_structured_field(x: torch.Tensor, plan: StructuredDssPlan,
                                rspheremp: torch.Tensor) -> torch.Tensor:
    """rspheremp * DSS(x) on [nelem, *mid, np, np] fields: the gather-free
    drop-in for ``dist.dss.dss_scaled`` on the whole sphere (counterpart of
    ``dss_scaled_structured_field``)."""
    cols, mid = _to_packed_cols(x)
    out = _rows(rspheremp).to(cols.dtype) * dss_structured(cols, plan)
    return _from_packed_cols(out, x.shape[0], mid)


def dss_project_structured_field(x: torch.Tensor, plan: StructuredDssPlan,
                                 spheremp: torch.Tensor,
                                 rspheremp: torch.Tensor) -> torch.Tensor:
    """rspheremp * DSS(spheremp * x): the ``dist.dss.dss_project`` drop-in
    (counterpart of ``dss_project_structured_field``)."""
    cols, mid = _to_packed_cols(x)
    cols = _rows(spheremp).to(cols.dtype) * cols
    out = _rows(rspheremp).to(cols.dtype) * dss_structured(cols, plan)
    return _from_packed_cols(out, x.shape[0], mid)


def apply_rsp_t(rsp_lanes: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y * rspheremp on the lane axis; ``rsp_lanes`` is [1, e16] or the
    two-float [2, e16] (hi + lo rows), then ``dss.mul_2f``."""
    if rsp_lanes.shape[0] == 2:
        return mul_2f(y, rsp_lanes[0:1], rsp_lanes[1:2])
    return rsp_lanes * y


def dss_structured_scaled_t(x: torch.Tensor, plan: StructuredDssPlan,
                            rsp_lanes: torch.Tensor) -> torch.Tensor:
    """rspheremp * DSS(x) for transposed [k, e16] fields."""
    return apply_rsp_t(rsp_lanes, dss_structured_t(x, plan))


def rsp_lanes_2f(spheremp, gdof, ndof: int) -> np.ndarray:
    """Two-float rspheremp lanes [2, e16] (hi + lo f32 rows), numpy: 1/S for
    S = the f64 sum over a dof's aliases of the f32-ROUNDED spheremp that the
    kernels multiply in. The single-f32 rspheremp has fl(rsp)*S = 1 + O(1e-8)
    with a fixed per-dof sign, a bias every DSS pass that integrates into a
    linear mass drift."""
    from .dss import rsp_2f

    hi, lo = rsp_2f(spheremp, gdof, ndof)
    return np.stack([hi.reshape(-1), lo.reshape(-1)])
