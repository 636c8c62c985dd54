"""Neighbour-wise halo exchange: DSS of element-sharded fields by
``mesh.ppermute`` rounds (counterpart of
``tinman_sandbox_tpu/dist/halo_ppermute.py``).

In place of a psum of the whole partition perimeter (``dist/halo.py``),
each shard exchanges partial sums only with the shards it borders, as
point-to-point rounds.

Host-side planning: the shard-adjacency graph (pairs sharing dofs) is edge
coloured greedily, edges taken in order of ``-len(shared)``, so each round
is a matching and a permutation; a shard that no edge of a round touches
sends to itself. For every pair the shared dofs are ordered by global dof
id on both sides, so the send and the receive tables align. A self-send
hands a shard its own buffer back, which is zeroed before it is added, as
JAX does. A dof spanning s shards receives partial sums from its s - 1
peers (cube corners span 3, in-face corners up to 4), so the pairwise
accumulation is the full assembly; its rounds add in an order that depends
on the shard, so a dof's aliases on different shards may differ in their
last bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .dss import _lift, from_cols, to_cols
from .halo import local_assembly, local_dofs, shard_rows

__all__ = ["PpermutePlan", "make_ppermute_plan", "dss_sum_ppermute",
           "dss_scaled_ppermute", "exchange_rounds"]


@dataclasses.dataclass(frozen=True)
class PpermutePlan:
    ndev: int
    nelem: int
    n_local_max: int
    rounds: int           # exchange rounds (graph edge colours)
    pair_len: int         # padded per-pair shared-dof count
    local_sid: Any        # [ndev, eloc*16] slot -> local dof id
    perms: Any            # `rounds` permutations, each ((src, dst), ...)
    send_idx: Any         # [ndev, rounds, pair_len] local dof ids (pad nlm)


def make_ppermute_plan(gdof: np.ndarray, ndev: int) -> PpermutePlan:
    gdof = np.asarray(gdof)
    uniqs, sids = local_dofs(gdof, ndev)
    nlm = max(len(u) for u in uniqs)
    dof_sets = [set(u.tolist()) for u in uniqs]

    # shard adjacency and the shared dofs of each pair (sorted by global id)
    pair_dofs = {}
    for d in range(ndev):
        for e in range(d + 1, ndev):
            shared = sorted(dof_sets[d] & dof_sets[e])
            if shared:
                pair_dofs[(d, e)] = shared

    # greedy edge colouring: each colour class is a matching
    colors: list = []
    for edge in sorted(pair_dofs, key=lambda p: -len(pair_dofs[p])):
        for cls in colors:
            if all(edge[0] not in p and edge[1] not in p for p in cls):
                cls.append(edge)
                break
        else:
            colors.append([edge])
    rounds = max(len(colors), 1)
    pair_len = max((len(v) for v in pair_dofs.values()), default=1)

    # a permutation and aligned send / receive tables a round
    perms = []
    send_idx = np.full((ndev, rounds, pair_len), nlm, np.int32)
    for m in range(rounds):
        cls = colors[m] if m < len(colors) else []
        perm = list(range(ndev))            # default: self-send
        for d, e in cls:
            perm[d], perm[e] = e, d
            local_of = {
                s: {dof: i for i, dof in enumerate(uniqs[s])} for s in (d, e)
            }
            dofs = pair_dofs[(d, e)]
            for s in (d, e):
                ids = [local_of[s][dof] for dof in dofs]
                send_idx[s, m, : len(ids)] = ids
        perms.append(tuple((src, dst) for src, dst in enumerate(perm)))

    return PpermutePlan(
        ndev=ndev, nelem=gdof.shape[0], n_local_max=nlm, rounds=rounds,
        pair_len=pair_len, local_sid=np.stack(sids), perms=tuple(perms),
        send_idx=send_idx,
    )


def exchange_rounds(locals_, plan: PpermutePlan, mesh, totals) -> None:
    """The exchange: round by round, each shard sends its partial sums at
    its send rows and adds what it receives into ``totals`` (in place; a
    self-send is zeroed first)."""
    dev = locals_[0].device
    for m in range(plan.rounds):
        idxs = shard_rows(plan.send_idx[:, m], mesh, dev)
        recv = mesh.ppermute([lo[i] for lo, i in zip(locals_, idxs)],
                             plan.perms[m])
        for s, tot, i, r in zip(mesh.shards, totals, idxs, recv):
            if plan.perms[m][s][1] == s:
                r = torch.zeros_like(r)
            tot.index_add_(0, i, r)


def dss_sum_ppermute(xs, plan: PpermutePlan, mesh) -> list:
    """``dist.dss.dss_sum`` of an element-sharded field by per-neighbour
    ppermute rounds. ``xs``: this process's shards, each
    [nelem / ndev, ..., np, np]. Returns the assembled shards."""
    if plan.ndev != mesh.n:
        raise ValueError(f"plan for {plan.ndev} shards on a mesh of {mesh.n}")
    sids = shard_rows(plan.local_sid, mesh, xs[0].device)
    locals_ = [local_assembly(to_cols(x), sid, plan.n_local_max)
               for x, sid in zip(xs, sids)]
    totals = [lo.clone() for lo in locals_]
    exchange_rounds(locals_, plan, mesh, totals)
    return [from_cols(t[sid], x.shape) for x, t, sid in zip(xs, totals, sids)]


def dss_scaled_ppermute(xs, plan: PpermutePlan, mesh, rsps) -> list:
    """rspheremp * ppermute-DSS(x) (the assembly of a spheremp-weighted
    update); ``rsps`` the shards' rspheremp [nelem / ndev, np, np]."""
    return [_lift(r, y.ndim) * y
            for r, y in zip(rsps, dss_sum_ppermute(xs, plan, mesh))]
