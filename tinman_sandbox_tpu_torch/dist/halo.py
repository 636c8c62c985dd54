"""Explicit-collective DSS of element-sharded fields: per-shard assembly and
one ``psum`` of the partition perimeter (counterpart of
``tinman_sandbox_tpu/dist/halo.py``).

Each shard assembles its OWN elements' shared dofs locally; the dofs whose
aliases span shards (the global partition perimeter) are summed in ONE
``mesh.psum`` of a perimeter-sized buffer. Interior and locally shared dofs
never leave the shard. The psum hands every shard the whole perimeter, not
only its neighbours' dofs; the per-neighbour exchange is
``dist/halo_ppermute.py``.

The plan (``make_dss_plan``) is host numpy, the JAX package's arrays bit for
bit. The body runs in phases over lists of per-shard tensors (one for each
shard this process holds, ``mesh.shards``): a local segment sum
(``index_add_`` into ``n_local_max + 1`` rows, the last the pad dummy) and a
scatter into the ``[n_gshared + 1, nmid]`` perimeter buffer; one
``mesh.psum``; ``local[shared_local] = buf[shared_global]`` and a gather
back through ``local_sid``. ``index_add_`` adds by atomics on the card, so
the sums there are not bit-reproducible from run to run; on the CPU it adds
in index order.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import NPSQ
from .dss import _lift, from_cols, to_cols

__all__ = ["DssPlan", "make_dss_plan", "dss_sum_halo", "dss_scaled_halo",
           "local_dofs", "local_assembly", "shard_rows"]


@dataclasses.dataclass(frozen=True)
class DssPlan:
    """The exchange plan of one mesh (host numpy)."""

    ndev: int
    nelem: int
    n_local_max: int      # max local assembled dofs a shard (+1 dummy row)
    n_gshared: int        # dofs whose aliases span shards (+1 dummy row)
    local_sid: Any        # [ndev, eloc*16] i32: slot -> local dof id
    shared_local: Any     # [ndev, Lmax] i32: local id of a shared dof
                          # (pad n_local_max)
    shared_global: Any    # [ndev, Lmax] i32: its global shared index
                          # (pad n_gshared)

    @property
    def perimeter_fraction(self) -> float:
        """Communicated dofs / total dofs: the halo-volume figure."""
        return self.n_gshared / (self.nelem * NPSQ)


def local_dofs(gdof: np.ndarray, ndev: int):
    """Each of ``ndev`` contiguous element shards' sorted global dofs and
    its slot -> local dof map (``np.unique``, int32)."""
    nelem = gdof.shape[0]
    if nelem % ndev:
        raise ValueError(f"{nelem} elements do not split into {ndev} shards")
    flat = np.asarray(gdof).reshape(ndev, nelem // ndev * NPSQ)
    uniqs, sids = [], []
    for d in range(ndev):
        uniq, sid = np.unique(flat[d], return_inverse=True)
        uniqs.append(uniq)
        sids.append(sid.astype(np.int32))
    return uniqs, sids


def make_dss_plan(gdof: np.ndarray, ndev: int) -> DssPlan:
    """Plan the exchange for ``gdof`` [nelem, np, np] split into ``ndev``
    contiguous element shards."""
    gdof = np.asarray(gdof)
    uniqs, sids = local_dofs(gdof, ndev)
    n_local_max = max(len(u) for u in uniqs)

    # dofs appearing in more than one shard
    shard_count = np.zeros(int(gdof.max()) + 1, np.int32)
    for u in uniqs:
        shard_count[u] += 1
    gshared = np.flatnonzero(shard_count > 1)
    gs_index = np.full(shard_count.size, -1, np.int64)
    gs_index[gshared] = np.arange(gshared.size)
    n_gshared = int(gshared.size)

    lmax = max(int(np.sum(gs_index[u] >= 0)) for u in uniqs) \
        if n_gshared else 1
    shared_local = np.full((ndev, lmax), n_local_max, np.int32)
    shared_global = np.full((ndev, lmax), n_gshared, np.int32)
    for d, u in enumerate(uniqs):
        mask = gs_index[u] >= 0
        ids = np.flatnonzero(mask)
        shared_local[d, : ids.size] = ids
        shared_global[d, : ids.size] = gs_index[u[mask]]

    return DssPlan(ndev=ndev, nelem=gdof.shape[0], n_local_max=n_local_max,
                   n_gshared=n_gshared, local_sid=np.stack(sids),
                   shared_local=shared_local, shared_global=shared_global)


def shard_rows(table: np.ndarray, mesh, device) -> list:
    """Rows ``mesh.shards`` of a per-shard host table, as int64 tensors on
    ``device``."""
    return [torch.from_numpy(table[s].astype(np.int64)).to(device)
            for s in mesh.shards]


def local_assembly(cols: torch.Tensor, sid: torch.Tensor,
                   nlm: int) -> torch.Tensor:
    """The segment sum of a shard's dof-major columns onto its local dofs:
    [nlm + 1, nmid], row ``nlm`` the dummy that padded indices hit."""
    out = torch.zeros(nlm + 1, cols.shape[1], dtype=cols.dtype,
                      device=cols.device)
    return out.index_add_(0, sid, cols)


def dss_sum_halo(xs, plan: DssPlan, mesh) -> list:
    """``dist.dss.dss_sum`` of an element-sharded field, with per-shard
    assembly and one psum of the perimeter. ``xs``: this process's shards,
    each [nelem / ndev, ..., np, np]. Returns the assembled shards."""
    if plan.ndev != mesh.n:
        raise ValueError(f"plan for {plan.ndev} shards on a mesh of {mesh.n}")
    dev = xs[0].device
    nlm, ngs = plan.n_local_max, plan.n_gshared
    sids = shard_rows(plan.local_sid, mesh, dev)
    sls = shard_rows(plan.shared_local, mesh, dev)
    sgs = shard_rows(plan.shared_global, mesh, dev)
    locals_, bufs = [], []
    for x, sid, sl, sg in zip(xs, sids, sls, sgs):
        local = local_assembly(to_cols(x), sid, nlm)
        buf = torch.zeros(ngs + 1, local.shape[1], dtype=x.dtype, device=dev)
        locals_.append(local)
        bufs.append(buf.index_add_(0, sg, local[sl]))
    bufs = mesh.psum(bufs)
    out = []
    for x, local, buf, sid, sl, sg in zip(xs, locals_, bufs, sids, sls, sgs):
        local[sl] = buf[sg]
        out.append(from_cols(local[sid], x.shape))
    return out


def dss_scaled_halo(xs, plan: DssPlan, mesh, rsps) -> list:
    """rspheremp * halo-DSS(x) (the assembly of a spheremp-weighted
    update); ``rsps`` the shards' rspheremp [nelem / ndev, np, np]."""
    return [_lift(r, y.ndim) * y
            for r, y in zip(rsps, dss_sum_halo(xs, plan, mesh))]
