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

__all__ = ["StructuredDssPlan", "make_structured_plan", "dss_structured",
           "dss_structured_scaled", "dss_structured_t",
           "dss_structured_scaled_t", "apply_rsp_t", "rsp_lanes_2f"]

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


def dss_structured_t(x: torch.Tensor, plan: StructuredDssPlan) -> torch.Tensor:
    """DSS (unscaled shared-dof sum) of a transposed [k, e16] field."""
    ne = plan.ne
    k, e16 = x.shape
    if e16 != 6 * ne * ne * NPSQ:
        raise ValueError(f"dss: e16={e16} does not match ne={ne}")
    x6 = x.reshape(k, 6, ne, ne, NP, NP).clone()

    # 1. alpha sweep (ei-neighbours share the i=3 / i=0 GLL columns)
    t = x6[:, :, :, :-1, NP - 1, :] + x6[:, :, :, 1:, 0, :]
    x6[:, :, :, :-1, NP - 1, :] = t
    x6[:, :, :, 1:, 0, :] = t

    # 2. beta sweep on the result
    t = x6[:, :, :-1, :, :, NP - 1] + x6[:, :, 1:, :, :, 0]
    x6[:, :, :-1, :, :, NP - 1] = t
    x6[:, :, 1:, :, :, 0] = t

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


def dss_structured(x: torch.Tensor, plan: StructuredDssPlan) -> torch.Tensor:
    """DSS (unscaled shared-dof sum) of a row-layout [e16, k] field."""
    return dss_structured_t(x.T, plan).T.contiguous()


def dss_structured_scaled(x: torch.Tensor, plan: StructuredDssPlan,
                          rsp_rows: torch.Tensor) -> torch.Tensor:
    """rspheremp * DSS(x) for row-layout [e16, k] fields; ``rsp_rows`` is
    [e16, 1]."""
    return rsp_rows * dss_structured(x, plan)


def apply_rsp_t(rsp_lanes: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y * rspheremp on the lane axis; ``rsp_lanes`` is [1, e16] or the
    two-float [2, e16] (hi + lo rows), then y*hi + y*lo."""
    if rsp_lanes.shape[0] == 2:
        return y * rsp_lanes[0:1] + y * rsp_lanes[1:2]
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
