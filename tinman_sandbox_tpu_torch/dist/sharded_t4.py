"""The face-sharded assembled step, and what the multi-device steps share
(counterpart of ``tinman_sandbox_tpu/dist/sharded_t4.py``).

The packed lane axis [*, E16] is cut into N contiguous shards: here whole
cube faces (N | 6, ``fps`` = 6/N faces a shard), in ``banded_t4.py``
element-row bands. ``shard_packed_t4`` cuts a packed array into the mesh's
per-shard tensors and ``unshard_packed_t4`` puts them back (the counterpart
of ``device_put`` with ``P(None, "e")``: the kernels need contiguous
operands, and a column slice of a row-major tensor is not contiguous).

Per shard, the CAAR kernel and the in-face sweeps are local; what crosses
shards is the compact side lines of the faces (``all_gather``). Every shard
then holds the line table [6 * 4 * nl, k] (face, side ``_SIDES``, position
along the line) of the whole sphere, which holds every fix lane, and its
fixup (``dss_fixup_cuda``) sums, for each of its own fix lanes, the same
table entries in the same order as the single-device fixup sums its slab:
the sharded DSS is bit for bit the single-device one. ``shard_fix_tables``
builds a shard's tables: its fix lanes (shard-local, ascending: the slab
rows its producer emits and the vd columns), and the line-table rows of each
fix value. The JAX package's traced shard index needed per-face lookup
tables (``_sharded_fixup_arrays``); here the shard index is a Python int, so
each shard's tables are built once with numpy.

``caar_dss_sharded_t4`` is the step: per shard the CAAR kernel with the
shard's slab, the line ``all_gather``, the fixup and the merged sweep
(``dss_sweep_cuda`` on the shard's whole faces), or with ``overlap`` the
merge-free sweep (``dss_sweep_nomerge_cuda``, no dependence on the gather)
and the patch of the fix lanes (``dss_patch_tiles_cuda``). Its ``_plain``
twin runs the plain versions. The JAX function's ``eb`` / ``lg`` /
compact-slab switches are TPU layouts with no counterpart, and so is its
rule that a shard of several faces needs 128 | ne*ne*16 lanes (a TPU tile):
here any N | 6 serves any ne.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import NP, NPSQ
from ..kernels.caar_t import caar_t4_cuda, caar_t4_plain
from ..kernels.dss import (
    FixTables, _band_sweep_plain, _fixup_arrays, _patch_plain,
    dss_extract_cuda, dss_extract_plain, dss_fixup_cuda, dss_fixup_plain,
    dss_patch_tiles_cuda, dss_sweep_banded_cuda,
    dss_sweep_banded_nomerge_cuda, dss_sweep_cuda, dss_sweep_nomerge_cuda,
    dss_sweep_nomerge_plain, dss_sweep_plain, make_fix_tables)
from ..kernels.hypervis_t import vlap_cuda, vlap_plain
from ..kernels.tracer_t import tracer_euler_cuda, tracer_euler_plain
from .sharding import LocalMesh
from .structured_dss import _SIDES, _side_line_idx

__all__ = ["make_face_mesh", "shard_packed_t4", "unshard_packed_t4",
           "shard_fix_tables", "caar_dss_sharded_t4",
           "caar_dss_sharded_t4_plain"]


def make_face_mesh(n: int = 6, device=None) -> LocalMesh:
    """A face mesh of ``n`` shards (n | 6) on one device."""
    if 6 % n:
        raise ValueError(f"face mesh needs n | 6, got {n}")
    return LocalMesh(n, device)


def shard_packed_t4(mesh, *arrays):
    """For each packed [rows, E16] array, the list of its mesh shards this
    process holds: contiguous [rows, E16/N] column blocks, shard order."""
    out = []
    for a in arrays:
        if a.shape[-1] % mesh.n:
            raise ValueError(f"{mesh.n} shards do not divide the "
                             f"{a.shape[-1]} lanes")
        w = a.shape[-1] // mesh.n
        out.append([a[..., s * w:(s + 1) * w].contiguous()
                    for s in mesh.shards])
    return tuple(out)


def unshard_packed_t4(mesh, xs) -> torch.Tensor:
    """The packed [rows, E16] array from its per-shard tensors (an
    ``all_gather`` on a ``DistMesh``)."""
    g = mesh.all_gather(xs)[0]
    return g.permute(1, 0, 2).reshape(g.shape[1], -1)


# -- the line table and the shard fix tables --------------------------------

@functools.lru_cache(maxsize=None)
def _line_fixup(plan):
    """(fix_col [E16] the single-device vals column of a lane or -1, src
    [nfix, 4] the single-device fixup's summands as rows of the line table
    [6*4*nl], -1 = none). Row (f*4 + side)*nl + t holds the lane
    ``_side_line_idx(ne, f, side)[t]``; a cube corner, which ends two lines,
    takes the first."""
    fix_lanes, read_lanes, src = _fixup_arrays(plan)
    ne = plan.ne
    nl = ne * NP
    row_of = {}
    for f in range(6):
        for si, side in enumerate(_SIDES):
            for t, lane in enumerate(_side_line_idx(ne, f, side)):
                row_of.setdefault(int(lane), (f * 4 + si) * nl + t)
    lane_row = np.asarray([row_of[int(l)] for l in read_lanes], np.int64)
    src_rows = np.where(src >= 0, lane_row[np.maximum(src, 0)], -1)
    fix_col = np.full(6 * ne * ne * NPSQ, -1, np.int64)
    fix_col[fix_lanes] = np.arange(len(fix_lanes))
    return fix_col, src_rows


def shard_fix_tables(plan, lo: int, hi: int, device) -> FixTables:
    """The fix tables of the shard holding lanes [lo, hi): its fix lanes
    (shard-local, ascending: the producer's slab rows and the vd columns),
    each summing the line-table rows of the single-device fixup."""
    fix_col, src = _line_fixup(plan)
    lanes = np.nonzero(fix_col[lo:hi] >= 0)[0]
    return make_fix_tables(plan.ne, hi - lo, lanes, lanes,
                           src[fix_col[lo + lanes]], device,
                           src_rows=24 * plan.ne * NP)


@dataclasses.dataclass(frozen=True)
class _FaceShard:
    fix: FixTables
    line_rows: torch.Tensor      # slab rows of the shard's [fps, 4, nl] lines


@functools.lru_cache(maxsize=None)
def _sharded_fixup_arrays(plan, N: int, shard: int, device: str) -> _FaceShard:
    """The static tables of face shard ``shard`` of N (counterpart of
    ``_sharded_fixup_arrays``, :46): its fix tables and the slab rows of
    its faces' side lines in line-table order."""
    ne = plan.ne
    fl = ne * ne * NPSQ
    fps = 6 // N
    lo = shard * fps * fl
    fix = shard_fix_tables(plan, lo, lo + fps * fl, device)
    rank = fix.fix_rank.cpu().numpy()
    lanes = np.concatenate([_side_line_idx(ne, f, side) - lo
                            for f in range(shard * fps, (shard + 1) * fps)
                            for side in _SIDES])
    return _FaceShard(fix, torch.from_numpy(rank[lanes].astype(np.int64))
                      .to(device))


# -- the closing pass and the two kits ---------------------------------------

def _per_object(fn, *lists):
    """[fn(*args) for args in zip(*lists)], computed once for each distinct
    tuple of tensors (a LocalMesh hands every shard the same gathered
    tensor)."""
    done, out = {}, []
    for args in zip(*lists):
        key = tuple(map(id, args))
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


@dataclasses.dataclass(frozen=True)
class _Kit:
    """The kernels a multi-device step runs, or their plain versions."""

    caar: object
    vlap: object
    euler: object
    extract: object
    fixup: object
    sweep: object            # (x, rsp, vd, fix, mix): the face shard's sweep
    nomerge: object          # (x, rsp, fix, mix)
    banded: object           # (x_ext, rsp, vd, band, mix)
    banded_nomerge: object   # (x_ext, rsp, band, mix)
    patch: object            # (w, vd, fix, mix), in place on w
    pure: bool


CUDA = _Kit(caar_t4_cuda, vlap_cuda, tracer_euler_cuda, dss_extract_cuda,
            dss_fixup_cuda, dss_sweep_cuda, dss_sweep_nomerge_cuda,
            dss_sweep_banded_cuda, dss_sweep_banded_nomerge_cuda,
            dss_patch_tiles_cuda, pure=False)
PLAIN = _Kit(caar_t4_plain, vlap_plain, tracer_euler_plain, dss_extract_plain,
             dss_fixup_plain, dss_sweep_plain, dss_sweep_nomerge_plain,
             _band_sweep_plain,
             lambda x_ext, rsp, bt, mix=None: _band_sweep_plain(
                 x_ext, rsp, None, bt, mix),
             lambda w, vd, fix, mix=None: _patch_plain(w, vd, fix.fix_lanes,
                                                       mix),
             pure=True)


def close_dss(sweep, nomerge, patch, pure, x, rsp, vd, tables, fix, mix,
              overlap):
    """The closing pass of a shard's DSS: the merged sweep, or with
    ``overlap`` the merge-free sweep and then the patch of the fix lanes
    ``fix``. A taller mx is updated in place by the kernels: there the
    merge-free sweep writes a new k-row tensor (the patch reads mx's fix
    lanes as they were), which is copied into mx's first rows."""
    if not overlap:
        return sweep(x, rsp, vd, tables, mix)
    k = vd.shape[0]
    if mix is not None and mix[0].shape[0] > k and not pure:
        mx, ca, cb = mix
        head = (mx[:k], ca, cb)
        mx[:k] = patch(nomerge(x, rsp, tables, head), vd, fix, head)
        return mx
    return patch(nomerge(x, rsp, tables, mix), vd, fix, mix)


def face_dss(kit, mesh, plan, xs, slabs, rsps, overlap: bool = False):
    """rspheremp * DSS of a face-sharded field from its per-shard slabs:
    the line ``all_gather``, then per shard the fixup and the closing pass.
    Lists over the mesh's shards."""
    tabs = [_sharded_fixup_arrays(plan, mesh.n, s, str(x.device))
            for s, x in zip(mesh.shards, xs)]
    k = xs[0].shape[0]
    lines = _per_object(lambda g: g.reshape(-1, k), mesh.all_gather(
        [slab[t.line_rows] for slab, t in zip(slabs, tabs)]))
    return [close_dss(kit.sweep, kit.nomerge, kit.patch, kit.pure, x, r,
                      kit.fixup(g, t.fix, r), t.fix, t.fix, None, overlap)
            for x, r, g, t in zip(xs, rsps, lines, tabs)]


def _sharded_step(kit, scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                  plan, rsp, mesh, moist, overlap):
    N = mesh.n
    if 6 % N:
        raise ValueError(f"the face-sharded step needs N | 6, got {N}")
    outs = [kit.caar(scal, *ops, dvv, moist=moist,
                     fix=_sharded_fixup_arrays(plan, N, s,
                                               str(ops[0].device)).fix)
            for s, ops in zip(mesh.shards,
                              zip(meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                                  omg))]
    s1 = face_dss(kit, mesh, plan, [o[0] for o in outs],
                  [o[5] for o in outs], rsp, overlap=overlap)
    return (s1,) + tuple([o[i] for o in outs] for i in range(1, 5))


def caar_dss_sharded_t4(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg,
                        dvv, plan, rsp, mesh, moist: bool = True,
                        overlap: bool = False):
    """The face-sharded assembled leapfrog step (counterpart of
    ``caar_dss_sharded_t4``): the contract of
    ``caar_dss_structured_packed_t4`` with every [*, E16] operand (meta, s0,
    sm1, qdp, pecnd, the accumulators, rsp) a list of the mesh's shards
    (``shard_packed_t4``); scal and dvv whole. Accumulators IN PLACE.
    Returns (s1, phi, vn0u, vn0v, omg), lists of shards; bit for bit the
    single-device step's."""
    return _sharded_step(CUDA, scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                         omg, dvv, plan, rsp, mesh, moist, overlap)


def caar_dss_sharded_t4_plain(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                              omg, dvv, plan, rsp, mesh, moist: bool = True,
                              overlap: bool = False):
    """``caar_dss_sharded_t4`` from the plain versions; pure."""
    return _sharded_step(PLAIN, scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                         omg, dvv, plan, rsp, mesh, moist, overlap)
