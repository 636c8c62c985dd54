"""Interior / boundary split of the ppermute tier (counterpart of
``tinman_sandbox_tpu/dist/overlap.py``).

Each shard's elements split into a boundary set (elements that own a
cross-shard dof) and an interior set. The exchange depends only on the
boundary elements' CAAR, so the interior CAAR can run in the exchange's
shadow:

  1. CAAR on the boundary subset;
  2. the shard's partial sums of its boundary elements' dofs (cross-shard
     dofs are among them; no interior element touches one) feed the
     ppermute rounds;
  3. CAAR on the interior subset, with no path to or from step 2;
  4. combine both subsets' np1, add the in-shard assembly and the received
     partials, scale by rspheremp.

On one card the steps run in this order and nothing overlaps: no stream is
added, the step is held to its numbers. Subsets are padded to
``nb_max`` / ``ni_max`` elements with element 0, masked to zero by ``bw`` /
``iw`` in the partials and in the combine (an unmasked pad would add
element 0's dofs twice). The same numbers as ``dist.step.caar_dss_step`` up
to the order of the sums.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import NPSQ, Config
from ..grid import HybridVCoord
from ..kernels.caar_array import caar_array
from .halo import local_assembly, shard_rows
from .halo_ppermute import PpermutePlan, exchange_rounds
from .sharding import _ELEM_AXIS
from .step import _PROGNOSTICS

__all__ = ["OverlapPlan", "make_overlap_plan", "caar_ppermute_overlap_step"]


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    nb_max: int           # padded boundary-element count a shard
    ni_max: int           # padded interior-element count a shard
    beid: Any             # [ndev, nb_max] local boundary element ids
    bw: Any               # [ndev, nb_max] 1.0 for real entries, 0.0 for pads
    ieid: Any             # [ndev, ni_max] local interior element ids
    iw: Any               # [ndev, ni_max]


def make_overlap_plan(gdof: np.ndarray, ndev: int) -> OverlapPlan:
    """Split each shard's local elements into boundary (owning at least one
    cross-shard dof) and interior sets, padded to uniform shapes."""
    gdof = np.asarray(gdof)
    nelem = gdof.shape[0]
    if nelem % ndev:
        raise ValueError(f"{nelem} elements do not split into {ndev} shards")
    eloc = nelem // ndev
    flat = gdof.reshape(ndev, eloc, NPSQ)

    dof_sets = [set(np.unique(flat[d]).tolist()) for d in range(ndev)]
    cross = [
        set().union(*(dof_sets[d] & dof_sets[e]
                      for e in range(ndev) if e != d)) or set()
        for d in range(ndev)
    ]
    b_lists, i_lists = [], []
    for d in range(ndev):
        isb = np.array([
            bool(set(flat[d, e].tolist()) & cross[d]) for e in range(eloc)
        ])
        b_lists.append(np.nonzero(isb)[0])
        i_lists.append(np.nonzero(~isb)[0])

    nb_max = max(1, max(len(b) for b in b_lists))
    ni_max = max(1, max(len(i) for i in i_lists))
    beid = np.zeros((ndev, nb_max), np.int32)
    bw = np.zeros((ndev, nb_max), np.float32)
    ieid = np.zeros((ndev, ni_max), np.int32)
    iw = np.zeros((ndev, ni_max), np.float32)
    for d in range(ndev):
        b, i = b_lists[d], i_lists[d]
        beid[d, : len(b)] = b
        bw[d, : len(b)] = 1.0
        ieid[d, : len(i)] = i
        iw[d, : len(i)] = 1.0
    return OverlapPlan(nb_max=nb_max, ni_max=ni_max, beid=beid, bw=bw,
                       ieid=ieid, iw=iw)


def _take_elems(tree, ids: torch.Tensor):
    """An element subset of a State / Derived / Geometry (``ids`` long)."""
    out = {}
    for f in dataclasses.fields(tree):
        x = getattr(tree, f.name)
        ax = _ELEM_AXIS.get(f.name, 0)
        if isinstance(x, torch.Tensor) and ax is not None:
            out[f.name] = x.index_select(ax, ids)
    return dataclasses.replace(tree, **out)


def _combine(xb, xi, beid, bw, ieid, iw, shape):
    """The shard's [eloc, ...] tensor from its boundary and interior
    subsets: each masked by its weights and added at its element ids, so a
    pad (element 0, weight 0) adds nothing."""
    lift = lambda w: w.reshape(-1, *([1] * (xb.ndim - 1)))
    out = torch.zeros(shape, dtype=xb.dtype, device=xb.device)
    out.index_add_(0, beid, xb * lift(bw))
    return out.index_add_(0, ieid, xi * lift(iw))


def _cols4(fields, nlev: int) -> torch.Tensor:
    """Four [n, nlev, np, np] fields as dof-major columns [n*16, 4*nlev]
    (field-major within a column)."""
    f = torch.stack(fields, dim=1)
    n = f.shape[0]
    return f.reshape(n, 4 * nlev, NPSQ).transpose(1, 2).reshape(
        n * NPSQ, 4 * nlev)


def caar_ppermute_overlap_step(states, deriveds, geoms, hv: HybridVCoord,
                               plan: PpermutePlan, oplan: OverlapPlan, mesh,
                               cfg: Config, dt2, eta_ave_w,
                               moist: bool = True):
    """``caar_dss_step`` on element shards: boundary CAAR, the ppermute
    exchange of the boundary partials, interior CAAR, then the combine,
    the assembly and the scale by rspheremp. ``states``, ``deriveds``,
    ``geoms``: this process's shards. Returns (states, deriveds)."""
    if plan.ndev != mesh.n:
        raise ValueError(f"plan for {plan.ndev} shards on a mesh of {mesh.n}")
    np1, nlev, nlm = cfg.np1, cfg.nlev, plan.n_local_max
    dev = states[0].u.device
    eloc = cfg.nelem // plan.ndev
    sids = shard_rows(plan.local_sid, mesh, dev)
    beids = shard_rows(oplan.beid, mesh, dev)
    ieids = shard_rows(oplan.ieid, mesh, dev)
    dtype = states[0].u.dtype
    bws = [torch.from_numpy(oplan.bw[s]).to(dev, dtype) for s in mesh.shards]
    iws = [torch.from_numpy(oplan.iw[s]).to(dev, dtype) for s in mesh.shards]
    sub = lambda trees, ids: [caar_array(
        _take_elems(st, i), _take_elems(dv, i), _take_elems(gm, i), hv, cfg,
        dt2, eta_ave_w, moist=moist, device=dev)
        for (st, dv, gm), i in zip(trees, ids)]
    trees = list(zip(states, deriveds, geoms))

    # 1. boundary CAAR; 2. its partials and the exchange rounds
    bout = sub(trees, beids)
    local_b = []
    for (sb, _), sid, beid, bw in zip(bout, sids, beids, bws):
        bcols = _cols4([getattr(sb, n)[np1] for n in _PROGNOSTICS], nlev) \
            * bw.repeat_interleave(NPSQ)[:, None]
        sid_b = sid.reshape(eloc, NPSQ)[beid].reshape(-1)
        local_b.append(local_assembly(bcols, sid_b, nlm))
    remote = [torch.zeros_like(lo) for lo in local_b]
    exchange_rounds(local_b, plan, mesh, remote)

    # 3. interior CAAR
    iout = sub(trees, ieids)

    # 4. combine, assemble, scale
    new_states, new_deriveds = [], []
    for (st, dv, gm), (sb, db), (si, di), sid, beid, bw, ieid, iw, rem in \
            zip(trees, bout, iout, sids, beids, bws, ieids, iws, remote):
        comb = lambda xb, xi, like: _combine(xb, xi, beid, bw, ieid, iw,
                                             like.shape)
        fcols = _cols4([comb(getattr(sb, n)[np1], getattr(si, n)[np1],
                             getattr(st, n)[np1]) for n in _PROGNOSTICS],
                       nlev)
        total = local_assembly(fcols, sid, nlm) + rem
        out = total[sid].reshape(eloc, NPSQ, 4 * nlev).transpose(1, 2)
        out = out.reshape(eloc, 4, nlev, NPSQ) * \
            gm.rspheremp.reshape(eloc, 1, 1, NPSQ)
        put = {}
        for i, n in enumerate(_PROGNOSTICS):
            x = getattr(st, n).clone()
            x[np1] = out[:, i].reshape(x.shape[1:])
            put[n] = x
        new_states.append(dataclasses.replace(st, **put))
        # the derived updates are per element (no assembly): combined
        new_deriveds.append(dataclasses.replace(dv, **{
            f.name: comb(getattr(db, f.name), getattr(di, f.name),
                         getattr(dv, f.name))
            for f in dataclasses.fields(dv)}))
    return new_states, new_deriveds
