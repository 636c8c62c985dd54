"""The band-sharded assembled step: the general multi-device path
(counterpart of ``tinman_sandbox_tpu/dist/banded_t4.py``).

Each cube face is cut into ``m`` bands of br = ne/m element rows; band
chunk c = face*m + b is bl = br*rl contiguous lanes (rl = 16*ne, one element
row), and shard s of N holds the cps = 6m/N chunks s*cps ... s*cps + cps - 1.
Per chunk the CAAR kernel and the in-face alpha sweep are local; the beta
partners of a band's first and last rows lie one row over, so each chunk is
extended with its two neighbouring element rows, [band | next | prev]
(``x_ext``): rows of the shard's other chunks, or from the shards before and
after by one ``ppermute`` each way. Where two shards' rows meet at a face
edge no row is sent; the halo is then zeros, which the sweep never reads.

The cube-edge and corner fixup needs the faces' side lines. Each chunk's
W and E line segments go to every shard by ``all_gather``; the S line (in
a face's first band) and the N line (in its last) by a ``psum`` of a zero
buffer that each shard fills at its own chunks' slots only, so each slot
sums one nonzero term: exact. Every shard then holds the whole sphere's line
table and runs the single-device fixup's sums on it for its own fix lanes
(``sharded_t4.shard_fix_tables``): bit for bit the single-device DSS, cube
corners (c0 + c1) + c2 included. The JAX package's affine value tables
(A + b*B into a per-face table) exist because its shard index is traced;
here c, the face f = c // m and the band b = c % m are Python ints, and the
tables are built once per shard with numpy.

``caar_dss_banded_t4`` is the step: per shard the CAAR kernel with the
shard's slab, the halo ``ppermute``, the extension, the line collectives,
the fixup and the banded sweep (``dss_sweep_banded_cuda``), or with
``overlap`` the merge-free banded sweep and the patch of the fix lanes
(``dss_patch_tiles_cuda``). ``dss_banded_t`` is the DSS alone on a
band-sharded field. Each has a ``_plain`` twin. The decompositions are the
JAX package's: m | ne, m >= 2, N | 6m, and 128 | bl unless cps = 1. Its
VMEM accounting (``banded_vmem_report``) and lane-group widths (``pick_lg``,
``_resolve_lg``) are TPU concerns with no counterpart.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import NP, NPSQ
from ..kernels.dss import BandTables, band_tables
from .sharded_t4 import CUDA, PLAIN, _per_object, close_dss, shard_fix_tables
from .structured_dss import _side_line_idx

__all__ = ["caar_dss_banded_t4", "caar_dss_banded_t4_plain", "dss_banded_t",
           "dss_banded_t_plain"]


@functools.lru_cache(maxsize=None)
def _banded_tables(plan, m: int, N: int) -> dict:
    """The static layout of m bands a face over N shards (counterpart of
    ``_banded_tables``, :100, and of the checks of ``_banded_dss_builder``,
    :321-326): sizes, the (first, last) flags of every chunk and the halo
    ``ppermute`` pairs. Raises on a decomposition the JAX package does not
    admit."""
    ne = plan.ne
    if m < 2 or ne % m:
        raise ValueError(f"banded DSS needs m >= 2 bands dividing ne={ne}, "
                         f"got m={m}")
    if (6 * m) % N:
        raise ValueError(f"banded DSS needs N | 6m, got N={N}, m={m}")
    rl, br = ne * NPSQ, ne // m
    bl, cps = br * rl, 6 * m // N
    if bl % 128 and cps != 1:
        raise ValueError(f"multi-chunk shards need 128 | band lanes "
                         f"(bl={bl})")
    return dict(
        ne=ne, nl=ne * NP, rl=rl, br=br, bl=bl, ext=bl + 2 * rl, cps=cps,
        seg=br * NP,
        first_last=tuple((c % m == 0, c % m == m - 1) for c in range(6 * m)),
        # a shard's last row goes forward and its first back, except where
        # the rows meet at a face edge
        send_fwd=tuple((s, s + 1) for s in range(N - 1)
                       if (s * cps + cps - 1) % m != m - 1),
        send_bwd=tuple((s, s - 1) for s in range(1, N)
                       if (s * cps) % m != 0))


@dataclasses.dataclass(frozen=True)
class _BandShard:
    band: BandTables
    we_rows: torch.Tensor        # slab rows of the chunks' W, E segments
    sn_rows: tuple               # (face, 0 = S / 1 = N, slab rows) a line


@functools.lru_cache(maxsize=None)
def _band_shard(plan, m: int, N: int, shard: int, device: str) -> _BandShard:
    """The static tables of band shard ``shard``: its BandTables (fix tables
    and chunk flags) and the slab rows of the line pieces it contributes,
    W and E segments [cps, 2, br*4] and its S / N lines."""
    T = _banded_tables(plan, m, N)
    ne, cps, bl, seg = T["ne"], T["cps"], T["bl"], T["seg"]
    lo = shard * cps * bl
    fix = shard_fix_tables(plan, lo, lo + cps * bl, device)
    rank = fix.fix_rank.cpu().numpy()
    chunks = range(shard * cps, (shard + 1) * cps)
    line = lambda f, side: _side_line_idx(ne, f, side) - lo
    we = [line(c // m, side)[(c % m) * seg:(c % m + 1) * seg]
          for c in chunks for side in ("W", "E")]
    sn = [(c // m, i, torch.from_numpy(rank[line(c // m, side)]
                                        .astype(np.int64)).to(device))
          for c in chunks for i, side in enumerate(("S", "N"))
          if T["first_last"][c][i]]
    band = band_tables(fix, bl, T["first_last"][shard * cps:
                                                (shard + 1) * cps])
    return _BandShard(band, torch.from_numpy(rank[np.concatenate(we)]
                                             .astype(np.int64)).to(device),
                      tuple(sn))


def band_extend(mesh, plan, m: int, xs):
    """Each shard's chunks extended with their neighbouring element rows,
    [band | next | prev] a chunk: the rows of the shard's other chunks, and
    at its ends the rows that the ``ppermute`` brings from the shards before
    and after (zeros where the rows meet at a face edge)."""
    T = _banded_tables(plan, m, mesh.n)
    rl, bl, cps = T["rl"], T["bl"], T["cps"]
    prev0 = mesh.ppermute([x[:, -rl:] for x in xs], T["send_fwd"])
    next_l = mesh.ppermute([x[:, :rl] for x in xs], T["send_bwd"])
    out = []
    for x, prv, nxt in zip(xs, prev0, next_l):
        pieces = []
        for l in range(cps):
            pieces += [x[:, l * bl:(l + 1) * bl],
                       x[:, (l + 1) * bl:(l + 1) * bl + rl]
                       if l < cps - 1 else nxt,
                       x[:, l * bl - rl:l * bl] if l > 0 else prv]
        out.append(torch.cat(pieces, dim=1))
    return out


def banded_dss(kit, mesh, plan, m: int, xs, slabs, rsps, mixes=None,
               overlap: bool = False):
    """rspheremp * DSS of a band-sharded field from its per-shard slabs
    (the closure of ``_banded_dss_builder``, :283): halo rows by
    ``ppermute``, the [band | next | prev] extension, the W / E
    ``all_gather`` and the S / N ``psum``, then per shard the fixup and the
    banded sweep (or with ``overlap`` the merge-free sweep and the patch).
    Lists over the mesh's shards; ``mixes`` one (mx, ca, cb) or None a
    shard; a taller mx is updated in place by the kernels."""
    T = _banded_tables(plan, m, mesh.n)
    nl = T["nl"]
    tabs = [_band_shard(plan, m, mesh.n, s, str(x.device))
            for s, x in zip(mesh.shards, xs)]
    k = xs[0].shape[0]
    x_ext = band_extend(mesh, plan, m, xs)

    # W / E: [N, cps*2*seg, k] in chunk order c = f*m + b -> [6, 2, nl, k]
    we = _per_object(
        lambda g: g.reshape(6, m, 2, T["seg"], k).permute(0, 2, 1, 3, 4)
        .reshape(6, 2, nl, k),
        mesh.all_gather([slab[t.we_rows] for slab, t in zip(slabs, tabs)]))
    bufs = []
    for slab, t in zip(slabs, tabs):
        buf = slab.new_zeros(6, 2, nl, k)
        for f, i, rows in t.sn_rows:
            buf[f, i] = slab[rows]
        bufs.append(buf)
    lines = _per_object(lambda a, b: torch.cat((a, b), 1).reshape(-1, k),
                        we, mesh.psum(bufs))
    mixes = mixes or [None] * len(xs)
    return [close_dss(kit.banded, kit.banded_nomerge, kit.patch, kit.pure,
                      xe, r, kit.fixup(g, t.band.fix, r), t.band,
                      t.band.fix, mx, overlap)
            for xe, r, g, t, mx in zip(x_ext, rsps, lines, tabs, mixes)]


def _banded_fix(plan, m, mesh, xs):
    return [_band_shard(plan, m, mesh.n, s, str(x.device)).band.fix
            for s, x in zip(mesh.shards, xs)]


def _banded_step(kit, scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                 plan, rsp, mesh, m, moist, overlap):
    fixes = _banded_fix(plan, m, mesh, s0)
    outs = [kit.caar(scal, *ops, dvv, moist=moist, fix=fix)
            for fix, ops in zip(fixes, zip(meta, s0, sm1, qdp, pecnd, vn0u,
                                           vn0v, omg))]
    s1 = banded_dss(kit, mesh, plan, m, [o[0] for o in outs],
                    [o[5] for o in outs], rsp, overlap=overlap)
    return (s1,) + tuple([o[i] for o in outs] for i in range(1, 5))


def caar_dss_banded_t4(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg,
                       dvv, plan, rsp, mesh, m: int, moist: bool = True,
                       overlap: bool = False):
    """The band-sharded assembled leapfrog step over ``mesh`` (N | 6m
    shards of cps = 6m/N band chunks; counterpart of
    ``caar_dss_banded_t4``): the contract of
    ``caar_dss_structured_packed_t4`` with every [*, E16] operand a list of
    the mesh's shards (``shard_packed_t4``); scal and dvv whole.
    Accumulators IN PLACE. Returns (s1, phi, vn0u, vn0v, omg), lists of
    shards; bit for bit the single-device step's."""
    return _banded_step(CUDA, scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                        omg, dvv, plan, rsp, mesh, m, moist, overlap)


def caar_dss_banded_t4_plain(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                             omg, dvv, plan, rsp, mesh, m: int,
                             moist: bool = True, overlap: bool = False):
    """``caar_dss_banded_t4`` from the plain versions; pure."""
    return _banded_step(PLAIN, scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v,
                        omg, dvv, plan, rsp, mesh, m, moist, overlap)


def _dss_banded(kit, x, plan, rsp, mesh, m, overlap):
    slabs = [kit.extract(xi, fix)
             for xi, fix in zip(x, _banded_fix(plan, m, mesh, x))]
    return banded_dss(kit, mesh, plan, m, x, slabs, rsp, overlap=overlap)


def dss_banded_t(x, plan, rsp, mesh, m: int, overlap: bool = False):
    """rspheremp * DSS of a band-sharded [k, E16] field, a list of shards
    (counterpart of ``dss_banded_t``): the extraction of each shard's slab,
    then the banded DSS. Returns the list of assembled shards."""
    return _dss_banded(CUDA, x, plan, rsp, mesh, m, overlap)


def dss_banded_t_plain(x, plan, rsp, mesh, m: int, overlap: bool = False):
    """``dss_banded_t`` from the plain versions; pure."""
    return _dss_banded(PLAIN, x, plan, rsp, mesh, m, overlap)
