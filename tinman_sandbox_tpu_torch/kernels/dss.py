"""Structured DSS on the transposed [k, E16] layout as three CUDA kernels
(counterpart of ``tinman_sandbox_tpu/kernels/dss_pallas.py``, the parts on
the assembled step's path).

The kernels are ``csrc/dss.cu`` (its note gives the algebra and the design):

  * ``dss_extract_cuda``: the fix-lane slab ``slab[r, row] = x[row,
    read_lanes[r]]`` (replaces ``extract_tiles_t`` / ``extract_tiles_ct``);
  * ``dss_fixup_cuda``: the cube-edge junction and pair sums with the flip,
    the cube-corner triple sums and the rspheremp scale, computed from the
    slab and stored transposed into the vals buffer ``vd[row, u]`` (replaces
    the XLA line math ``_fixup_from_rows`` and ``vals_to_vd_pallas``);
  * ``dss_sweep_cuda``: the alpha and beta in-face sweeps and the scale,
    with the fix lanes taking their value from ``vd`` (replaces
    ``dss_sweeps_pallas_t`` / ``dss_sweeps_pallas_ct``), and their affine
    epilogue: with ``mix=(mx, ca, cb)`` the output is ``ca*mx + cb*w`` for
    the assembled w, two products and then their sum. ``mx`` may have more
    rows than x: the result is then written IN PLACE into ``mx``'s first
    rows, the rest ride through untouched, and ``mx`` is returned. The
    kernel moves aligned groups of 4 lanes (16-byte aligned fields), its
    launch from ``sweep_plan(rows, e16)``, a pure function of the shape
    that refuses the shapes the kernel does not take (the plain version on
    CPU tensors takes any).

Each has a plain PyTorch version (``dss_extract_plain`` etc.) that computes
the same f32 adds and products in the same order, so kernel and plain
version agree bit for bit. The wrappers check their operands, run the plain
version for CPU tensors (any float dtype) and launch the kernel for CUDA
tensors (float32), counting launches in ``<wrapper>.launches``.

``fix_tables(plan, device)`` builds the static tables once per plan and
device: the ascending ``read_lanes`` the slab holds, ``fix_rank`` [E16]
(slab row or -1, which the CAAR kernel's slab output also takes),
``fix_lanes`` (the fix lanes in vals-column order: the line interiors of the
24 face sides, then each cube corner's three aliases), ``fix_col`` [E16]
(vals column or -1) and ``fix_src`` [nfix, 4] (the slab rows each fix value
sums). rspheremp must be constant over the aliases of a dof, as the
assembled inverse mass and ``rsp_lanes_2f`` are; the fixup scales each fix
lane by its own rspheremp.

``dss_structured_t_cuda`` is the whole DSS (extract, fixup, sweep) and
``dss_structured_t_cuda_pre`` the same with the slab already in hand, as the
CAAR kernel emits it.

The sweep/patch split (the ring-fused steps' closer, counterpart of
``dss_structured_t_pallas_patch``, ``dss_pallas.py:1432``):

  * ``dss_sweep_nomerge_cuda``: the sweep kernel with its merge turned off
    (replaces ``dss_sweeps_pallas_nomerge``, :335): every lane, fix lanes
    included, gets rspheremp times its in-face alpha-then-beta sum, and the
    fix lanes keep those partial sums; ``mix`` as ``dss_sweep_cuda``;
  * ``dss_merge_patch_cuda``: IN PLACE on a merge-free output w, each fix
    lane gets its fixup value vd[row, col], or with ``mix=(mx, ca, cb)``
    ``ca*mx + cb*vd``, the sweep's own fix-lane expression; every other
    lane keeps its bits (replaces ``merge_patch_pallas``, :1477);
  * ``dss_structured_t_cuda_patch``: fixup, merge-free sweep, patch; bit for
    bit ``dss_structured_t_cuda_pre``.

The multi-device DSS (counterpart of the banded sweeps and the shard-local
patch of ``dss_pallas.py``; the steps are in ``dist/banded_t4.py`` and
``dist/sharded_t4.py``):

  * ``dss_sweep_banded_cuda``: the sweep of one shard's band chunks, each
    extended with its two neighbouring element rows ([band | next | prev],
    ``x_ext``), the fix lanes taking vd (replaces ``dss_sweeps_banded_t``,
    :428, and ``dss_sweeps_banded_ct``, :544); ``dss_sweep_banded_nomerge_
    cuda`` the same with the merge off (replaces
    ``dss_sweeps_banded_nomerge``, :190); ``mix`` as ``dss_sweep_cuda``;
  * ``dss_patch_tiles_cuda``: the patch kernel on a shard's own fix lanes,
    w and mx possibly taller than vd (replaces ``merge_patch_tiles``, :251).

They take ``BandTables`` (``band_tables``): the shard's ``FixTables`` and
one first / last flag a chunk in place of the TPU's bf16 lane masks and
tile-dense or compact value buffers. The banded sweep kernel runs the sweep
kernel's float4 groups; ``band_layout`` checks the layout they rely on.
``dss_sweep_banded_plain``, ``dss_sweep_banded_nomerge_plain`` and
``dss_patch_tiles_plain`` are the plain versions at the JAX functions'
signatures (masked rolls, 128-lane tiles, one-hot placement tables),
sharing their arithmetic with the wrappers' CPU path.

``fix_vals3`` (:1412) and its per-tile [nt, M, k] value blocks are a
128-lane-tile layout with no counterpart here: ``dss_fixup_cuda`` already
gives one value per fix lane (vd [k, nfix]), which the patch places.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import NP, NPSQ
from . import _build

__all__ = ["FixTables", "fix_tables", "make_fix_tables", "dss_extract_plain",
           "dss_fixup_plain", "dss_sweep_plain", "dss_sweep_nomerge_plain",
           "dss_merge_patch_plain", "dss_extract_cuda", "dss_fixup_cuda",
           "dss_sweep_cuda", "dss_sweep_nomerge_cuda", "dss_merge_patch_cuda",
           "dss_structured_t_cuda", "dss_structured_t_cuda_pre",
           "dss_structured_t_cuda_patch", "BandTables", "band_tables",
           "band_masks", "dss_sweep_banded_plain",
           "dss_sweep_banded_nomerge_plain", "dss_patch_tiles_plain",
           "dss_sweep_banded_cuda", "dss_sweep_banded_nomerge_cuda",
           "dss_patch_tiles_cuda", "SweepPlan", "sweep_plan", "band_layout"]

# the sweeps' grids put rows on their y axis
_MAX_ROWS = 65535

# the sweep kernel's plan (csrc/dss.cu kSweepThreads, kSweepBlocks) on the
# H100's SMs: 256 groups of 4 lanes a block, one row a thread, registers
# capped so that an SM holds 6 blocks
SWEEP_THREADS = 256
SWEEP_BLOCKS_PER_SM = 6
SMS = 132


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """The launch of the sweep kernel on [rows, e16]: ``threads`` lane
    groups of 4 a block along x, one row a thread along y; ``blocks_per_sm``
    is the kernel's register cap's guarantee."""

    rows: int
    e16: int
    threads = SWEEP_THREADS
    blocks_per_sm = SWEEP_BLOCKS_PER_SM

    @property
    def grid(self) -> tuple:
        return -(-self.e16 // (4 * self.threads)), self.rows

    @property
    def blocks(self) -> int:
        gx, gy = self.grid
        return gx * gy

    @property
    def waves(self) -> float:
        return self.blocks / (SMS * self.blocks_per_sm)


@functools.lru_cache(maxsize=None)
def sweep_plan(rows: int, e16: int) -> SweepPlan:
    """The sweep kernel's launch plan at [rows, e16], a pure function of the
    shape (one plan, no switch). Raises on shapes the kernel refuses: rows
    outside the grid's y axis (1..65535) or an E16 that is not a positive
    multiple of 16."""
    if e16 < 1 or e16 % NPSQ:
        raise ValueError(f"sweep: E16={e16} is not a positive multiple of "
                         f"{NPSQ}")
    if not 1 <= rows <= _MAX_ROWS:
        raise ValueError(f"sweep: {rows} rows outside the grid's 1.."
                         f"{_MAX_ROWS}")
    return SweepPlan(rows, e16)


@dataclasses.dataclass(frozen=True)
class FixTables:
    """Static fix-lane tables of one plan on one device (int32 tensors)."""

    ne: int
    e16: int
    read_lanes: torch.Tensor     # [nfix] ascending lanes of the slab rows
    fix_rank: torch.Tensor       # [E16] slab row of a lane, or -1
    fix_lanes: torch.Tensor      # [nfix] lane of each vals column
    fix_col: torch.Tensor        # [E16] vals column of a lane, or -1
    fix_src: torch.Tensor        # [nfix, 4] slab rows summed, -1 = none
    read_col: torch.Tensor       # [nfix] vals column of each read lane
    # rows of the slab that fix_src indexes, where it is not the extracted
    # slab of nfix rows (0): a shard's fixup reads the gathered side lines
    src_rows: int = 0

    @property
    def nfix(self) -> int:
        return int(self.read_lanes.shape[0])

    @property
    def nsrc(self) -> int:
        return self.src_rows or self.nfix


def _fixup_arrays(plan):
    """(fix_lanes, read_lanes, fix_src) as numpy, derived from the line
    lanes of each cube edge's two face sides (``_side_line_idx`` order) and
    the cube corners' aliases (counterpart of ``_fixup_arrays`` of the
    JAX package's ``dss_pallas.py``)."""
    from ..dist.structured_dss import _side_line_idx

    ne = plan.ne
    lines = []
    for fa, sa, fb, sb, _ in plan.edges:
        lines.append(_side_line_idx(ne, fa, sa))
        lines.append(_side_line_idx(ne, fb, sb))
    idx_lines = np.stack(lines).astype(np.int64)            # [24, nl]
    corner = np.asarray(plan.corner_rows, np.int64)         # [8, 3]
    nl = idx_lines.shape[1]
    fix_lanes = np.concatenate([idx_lines[:, 1:-1].reshape(-1),
                                corner.reshape(-1)])
    read_lanes = np.unique(fix_lanes)
    if len(read_lanes) != len(fix_lanes):
        raise AssertionError("fix lanes are not unique")
    rank = {int(l): r for r, l in enumerate(read_lanes)}

    def junction(t):
        """Position on the same line sharing a dof with position t."""
        if t % NP == NP - 1 and t < nl - 1:
            return t + 1
        if t % NP == 0 and t > 0:
            return t - 1
        return None

    def rows(line, t):
        tj = junction(t)
        return (rank[int(idx_lines[line, t])],
                -1 if tj is None else rank[int(idx_lines[line, tj])])

    src = []
    for line in range(len(lines)):
        flip = plan.edges[line // 2][4]
        for t in range(1, nl - 1):
            src.append(rows(line, t) + rows(line ^ 1, nl - 1 - t if flip
                                            else t))
    for c in corner:
        src += [(rank[int(c[0])], rank[int(c[1])], rank[int(c[2])], -1)] * 3
    return fix_lanes, read_lanes, np.asarray(src, np.int32)


def make_fix_tables(ne: int, e16: int, fix_lanes, read_lanes, fix_src,
                    device, src_rows: int = 0) -> FixTables:
    """FixTables on ``device`` from numpy: the fix lanes in vals-column
    order, the ascending lanes of the slab rows, the [nfix, 4] rows each fix
    value sums (of a slab of ``src_rows`` rows, 0 = the extracted slab)."""
    fix_rank = np.full(e16, -1, np.int32)
    fix_rank[read_lanes] = np.arange(len(read_lanes), dtype=np.int32)
    fix_col = np.full(e16, -1, np.int32)
    fix_col[fix_lanes] = np.arange(len(fix_lanes), dtype=np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    return FixTables(ne=ne, e16=e16, read_lanes=t(read_lanes),
                     fix_rank=t(fix_rank), fix_lanes=t(fix_lanes),
                     fix_col=t(fix_col), fix_src=t(fix_src),
                     read_col=t(fix_col[read_lanes]), src_rows=src_rows)


@functools.lru_cache(maxsize=None)
def _fix_tables_cached(plan, device: str) -> FixTables:
    fix_lanes, read_lanes, src = _fixup_arrays(plan)
    return make_fix_tables(plan.ne, 6 * plan.ne * plan.ne * NPSQ, fix_lanes,
                           read_lanes, src, device)


def fix_tables(plan, device) -> FixTables:
    """The fix-lane tables of ``plan`` on ``device``, built once each."""
    return _fix_tables_cached(plan, str(torch.device(device)))


# -- plain versions ----------------------------------------------------------

def dss_extract_plain(x: torch.Tensor, tables: FixTables) -> torch.Tensor:
    """[k, E16] -> slab [nfix, k]: slab[r] = x[:, read_lanes[r]]."""
    return x[:, tables.read_lanes.long()].T.contiguous()


def _scale(v: torch.Tensor, rsp_rows: torch.Tensor) -> torch.Tensor:
    """v * rspheremp with rsp_rows [nr, ...] broadcast on v: for two rows
    ``fmaf(v, hi, v*lo)`` (``dist.dss.mul_2f``, the kernels' scale)."""
    if rsp_rows.shape[0] == 2:
        from ..dist.dss import mul_2f

        return mul_2f(v, rsp_rows[0], rsp_rows[1])
    return v * rsp_rows[0]


def dss_fixup_plain(slab: torch.Tensor, tables: FixTables,
                    rsp: torch.Tensor) -> torch.Tensor:
    """slab [nsrc, k] -> vals buffer vd [k, nfix]: the fix value of each
    fix lane, (g[s0] + g[s1]) + (g[s2] + g[s3]) scaled by its rspheremp."""
    src = tables.fix_src.long()
    zero = slab.new_zeros(())

    def row(c):
        s = src[:, c]
        return torch.where((s >= 0)[:, None], slab[s.clamp(min=0)], zero)

    v = (slab[src[:, 0]] + row(1)) + (slab[src[:, 2]] + row(3))
    r = rsp[:, tables.fix_lanes.long()][:, :, None]          # [nr, nfix, 1]
    return _scale(v, r).T.contiguous()


def dss_fixup_emulated(slab: torch.Tensor, tables: FixTables,
                       rsp: torch.Tensor):
    """csrc/dss.cu's tiled fixup kernel in torch, for the tests: each block
    (bx, by) of the grid, each thread (tx, ty) of its 32 x 8, in its summing
    pass (row by*32 + tx, fix lane bx*32 + ty + 8*i, into tile[du][tx]) and
    its storing pass (vd[by*32 + ty + 8*i, bx*32 + tx] = tile[tx][dr]), with
    the kernel's bounds tests. Returns (vd, writes), writes[row, u] the
    stores that element of vd took."""
    tile_n, rows_a = 32, 8
    n, k = tables.nfix, slab.shape[1]
    gx, gy = -(-n // tile_n), -(-k // tile_n)
    grid = torch.meshgrid(torch.arange(gx), torch.arange(gy),
                          torch.arange(rows_a), torch.arange(tile_n),
                          torch.arange(tile_n // rows_a), indexing="ij")
    bx, by, ty, tx, it = (x.reshape(-1) for x in grid)
    tile = torch.full((gx, gy, tile_n, tile_n + 1), float("nan"),
                      dtype=slab.dtype)
    # summing pass: a warp (fixed ty, it) sums fix lane u over 32 rows
    row, du = by * tile_n + tx, ty + rows_a * it
    u = bx * tile_n + du
    ok = (row < k) & (u < n)
    row, du, u, b, c, t = (x[ok] for x in (row, du, u, bx, by, tx))
    src = tables.fix_src.long()[u]
    at = lambda col: slab[src[:, col].clamp(min=0), row]
    za = torch.where(src[:, 1] >= 0, at(0) + at(1), at(0))
    zb = torch.where(src[:, 3] >= 0, at(2) + at(3), at(2))
    lanes = tables.fix_lanes.long()[u]
    tile[b, c, du, t] = _scale(za + zb, rsp[:, lanes])
    # storing pass: a warp (fixed ty, it) stores 32 fix lanes of one row
    u, dr = bx * tile_n + tx, ty + rows_a * it
    row = by * tile_n + dr
    ok = (u < n) & (row < k)
    vd = torch.full((k, n), float("nan"), dtype=slab.dtype)
    writes = torch.zeros((k, n), dtype=torch.long)
    vd[row[ok], u[ok]] = tile[bx[ok], by[ok], tx[ok], dr[ok]]
    writes.index_put_((row[ok], u[ok]), torch.ones_like(row[ok]),
                      accumulate=True)
    return vd, writes


def _sweep_masks(ne: int, e16: int, device):
    lane = torch.arange(e16, device=device)
    i, j = (lane // NP) % NP, lane % NP
    ei, ej = (lane // NPSQ) % ne, (lane // (NPSQ * ne)) % ne
    return ((i == NP - 1) & (ei < ne - 1), (i == 0) & (ei > 0),
            (j == NP - 1) & (ej < ne - 1), (j == 0) & (ej > 0))


def _check_mix(name, x, mix):
    """Validate ``mix=(mx, ca, cb)`` against x; returns (mx, ca, cb) with
    the coefficients as Python floats (a float32 value converts exactly)."""
    mx, ca, cb = mix
    if mx.ndim != 2 or mx.shape[1] != x.shape[1] or mx.shape[0] < x.shape[0]:
        raise ValueError(f"{name}: mix field must be [>= {x.shape[0]}, "
                         f"{x.shape[1]}], got {tuple(mx.shape)}")
    return mx, float(ca), float(cb)


def _swept_plain(x: torch.Tensor, rsp: torch.Tensor, ne: int):
    """rspheremp * (alpha then beta in-face sweep of x) at every lane."""
    a_hi, a_lo, b_hi, b_lo = _sweep_masks(ne, x.shape[1], x.device)
    db = NPSQ * ne - (NP - 1)
    zero = x.new_zeros(())
    part = lambda m, y, s: torch.where(m, torch.roll(y, s, 1), zero)
    y = x + part(a_hi, x, -NP) + part(a_lo, x, NP)
    z = y + part(b_hi, y, -db) + part(b_lo, y, db)
    return _scale(z, rsp[:, None, :])


def _mix_plain(name, x, w, mix):
    """ca*mx + cb*w for the first rows of mx, its further rows unchanged;
    a bf16 mx upcast exactly to w's dtype first."""
    if mix is None:
        return w
    mx, ca, cb = _check_mix(name, x, mix)
    mx = mx.to(w.dtype)
    k = x.shape[0]
    return torch.cat([ca * mx[:k] + cb * w, mx[k:]])


def dss_sweep_plain(x: torch.Tensor, rsp: torch.Tensor, vd: torch.Tensor,
                    tables: FixTables, mix=None) -> torch.Tensor:
    """rspheremp * (alpha then beta in-face sweep of x), the fix lanes
    taking vd[:, fix_col]. x [k, E16]; rsp [1 or 2, E16]; vd [k, nfix].
    With ``mix=(mx, ca, cb)`` returns ca*mx + cb*that; rows of a taller mx
    beyond x's come back unchanged. Pure: always a new tensor."""
    w = _swept_plain(x, rsp, tables.ne)
    col = tables.fix_col.long()
    w = torch.where(col >= 0, vd[:, col.clamp(min=0)], w)
    return _mix_plain("dss_sweep", x, w, mix)


def dss_sweep_nomerge_plain(x: torch.Tensor, rsp: torch.Tensor,
                            tables: FixTables, mix=None) -> torch.Tensor:
    """``dss_sweep_plain`` without the merge: every lane, fix lanes
    included, gets rspheremp * (its alpha then beta in-face sum); ``mix``
    as there. Pure."""
    return _mix_plain("dss_sweep_nomerge", x,
                      _swept_plain(x, rsp, tables.ne), mix)


def dss_merge_patch_plain(w: torch.Tensor, vd: torch.Tensor,
                          tables: FixTables, mix=None) -> torch.Tensor:
    """IN PLACE: w[:, fix_lanes] = vd, or with ``mix=(mx, ca, cb)`` (mx of
    w's shape) ca*mx[:, fix_lanes] + cb*vd. Returns w."""
    if mix is not None and tuple(mix[0].shape) != tuple(w.shape):
        raise ValueError(f"dss_merge_patch: mix field must be "
                         f"{tuple(w.shape)}, got {tuple(mix[0].shape)}")
    return _patch_plain(w, vd, tables.fix_lanes, mix)


# -- kernels -----------------------------------------------------------------

def _check(name, tensors: dict, dtype=None):
    """Common operand checks; returns the device. ``tensors`` maps operand
    names to (tensor, shape)."""
    first = next(iter(tensors.values()))[0]
    dev = first.device
    dtype = dtype or first.dtype
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: needs float fields, got {dtype}")
    if dev.type == "cuda" and dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 only")
    for op, (t, shape) in tensors.items():
        want = torch.int32 if op in ("fix_src", "read_lanes", "fix_lanes",
                                     "fix_col") else dtype
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {op} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != dev or t.dtype != want:
            raise ValueError(f"{name}: {op} is {t.dtype} on {t.device}, "
                             f"expected {want} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {op} must be contiguous")
    return dev


def _check_rsp(name, rsp, e16):
    if rsp.ndim != 2 or rsp.shape[0] not in (1, 2) or rsp.shape[1] != e16:
        raise ValueError(f"{name}: rsp must be [1 or 2, {e16}], got "
                         f"{tuple(rsp.shape)}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def dss_extract_cuda(x: torch.Tensor, tables: FixTables) -> torch.Tensor:
    """slab [nfix, k] of x [k, E16] (kernel ``dss_extract``)."""
    k, n = x.shape[0], tables.nfix
    dev = _check("dss_extract", {"x": (x, (k, tables.e16)),
                                 "read_lanes": (tables.read_lanes, (n,))},
                 dtype=x.dtype)
    if dev.type == "cpu":
        return dss_extract_plain(x, tables)
    slab = torch.empty(n, k, dtype=x.dtype, device=dev)
    err = _build.library("dss").dss_extract_launch(
        x.data_ptr(), tables.read_lanes.data_ptr(), slab.data_ptr(), n, k,
        tables.e16, _stream(dev), dev.index)
    _build.check_launch("dss", err)
    dss_extract_cuda.launches += 1
    return slab


dss_extract_cuda.launches = 0


def dss_fixup_cuda(slab: torch.Tensor, tables: FixTables,
                   rsp: torch.Tensor) -> torch.Tensor:
    """vd [k, nfix] from slab [nsrc, k] (kernel ``dss_fixup``): the
    extracted slab, or a shard's gathered side lines."""
    n, k = tables.nfix, slab.shape[1]
    _check_rsp("dss_fixup", rsp, tables.e16)
    dev = _check("dss_fixup", {"slab": (slab, (tables.nsrc, k)),
                               "rsp": (rsp, tuple(rsp.shape)),
                               "fix_src": (tables.fix_src, (n, 4)),
                               "fix_lanes": (tables.fix_lanes, (n,))},
                 dtype=slab.dtype)
    if dev.type == "cpu":
        return dss_fixup_plain(slab, tables, rsp)
    if tables.fix_src.data_ptr() % 16:
        raise ValueError("dss_fixup: fix_src must be 16-byte aligned")
    vd = torch.empty(k, n, dtype=slab.dtype, device=dev)
    err = _build.library("dss").dss_fixup_launch(
        slab.data_ptr(), tables.fix_src.data_ptr(),
        tables.fix_lanes.data_ptr(), rsp.data_ptr(), rsp.shape[0],
        tables.e16, vd.data_ptr(), n, k, _stream(dev), dev.index)
    _build.check_launch("dss", err)
    dss_fixup_cuda.launches += 1
    return vd


dss_fixup_cuda.launches = 0


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def _sweep(name, x, rsp, vd, tables, mix):
    """Check and run one sweep (vd None: merge-free); True where it
    launched the kernel. Returns (out, launched)."""
    k, e16, n = x.shape[0], tables.e16, tables.nfix
    _check_rsp(name, rsp, e16)
    ops = {"x": (x, (k, e16)), "rsp": (rsp, tuple(rsp.shape))}
    if vd is not None:
        ops.update({"vd": (vd, (k, n)), "fix_col": (tables.fix_col, (e16,))})
    mx, ca, cb = (None, 0.0, 0.0) if mix is None else _check_mix(name, x, mix)
    bf_mix = mx is not None and mx.dtype == torch.bfloat16
    if bf_mix:
        # the stored qdp of a first bf16 tracer step (bench --prim
        # --storage): the merged sweep reads it and writes a new field
        if vd is None:
            raise ValueError(f"{name}: a bfloat16 mix field takes the merged "
                             "sweep only")
        if tuple(mx.shape) != (k, e16) or mx.device != x.device or \
                not mx.is_contiguous():
            raise ValueError(f"{name}: a bfloat16 mix field must be a "
                             f"contiguous [{k}, {e16}] tensor on {x.device} "
                             "(the output is a new tensor of x's dtype), got "
                             f"{tuple(mx.shape)} on {mx.device}")
    elif mx is not None:
        ops["mix field"] = (mx, tuple(mx.shape))
    dev = _check(name, ops, dtype=x.dtype)
    in_place = mx is not None and mx.shape[0] > k
    if in_place and _overlap(mx, x):
        raise ValueError(f"{name}: the in-place mix field overlaps x")
    if dev.type == "cpu":
        plain = lambda m: (dss_sweep_nomerge_plain(x, rsp, tables, m)
                           if vd is None else
                           dss_sweep_plain(x, rsp, vd, tables, m))
        if not in_place:
            return plain(mix), False
        mx[:k] = plain((mx[:k], ca, cb))
        return mx, False
    sweep_plan(k, e16)          # raises on the shapes the kernel refuses
    out = mx if in_place else torch.empty_like(x)
    # the kernel reads and writes 16-byte groups of lanes
    for op, t in (("x", x), ("rsp", rsp), ("mix field", mx), ("out", out),
                  ("fix_col", None if vd is None else tables.fix_col)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {op} must be 16-byte aligned")
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = _build.library("dss").dss_sweep_launch(
        x.data_ptr(), rsp.data_ptr(), rsp.shape[0], ptr(vd), n,
        0 if vd is None else tables.fix_col.data_ptr(), ptr(mx), int(bf_mix),
        ca, cb, out.data_ptr(), k, e16, tables.ne, _stream(dev), dev.index)
    _build.check_launch("dss", err)
    return out, True


def dss_sweep_cuda(x: torch.Tensor, rsp: torch.Tensor, vd: torch.Tensor,
                   tables: FixTables, mix=None) -> torch.Tensor:
    """The assembled field [k, E16] from x, rsp and the vals buffer vd
    [k, nfix] (kernel ``dss_sweep``). The partner reads need the pre-sweep
    x, so the output never aliases x: it is a new tensor, also with
    ``mix=(mx, ca, cb)`` (ca*mx + cb*assembled) when mx has x's height. A
    TALLER mx (the [4*nlev] state around a [3*nlev] x) is updated IN PLACE
    in its first k rows and returned; it must not overlap x. mx may be
    bf16 (x's shape only; read upcast exactly, the output a new tensor of
    x's dtype), as the JAX package's full step hands its sweep the stored
    qdp under ``bench --prim --storage``: such launches also count in
    ``dss_sweep_cuda.storage_launches``."""
    out, launched = _sweep("dss_sweep", x, rsp, vd, tables, mix)
    dss_sweep_cuda.launches += launched
    dss_sweep_cuda.storage_launches += launched and mix is not None and \
        mix[0].dtype == torch.bfloat16
    return out


dss_sweep_cuda.launches = 0
dss_sweep_cuda.storage_launches = 0   # those with a bf16 mix field


def dss_sweep_nomerge_cuda(x: torch.Tensor, rsp: torch.Tensor,
                           tables: FixTables, mix=None) -> torch.Tensor:
    """The merge-free sweep (kernel ``dss_sweep`` with the merge off,
    counterpart of ``dss_sweeps_pallas_nomerge``): rspheremp * the in-face
    sum at every lane, the fix lanes keeping their partial sums for
    ``dss_merge_patch_cuda``. Output and ``mix`` forms as
    ``dss_sweep_cuda``."""
    out, launched = _sweep("dss_sweep_nomerge", x, rsp, None, tables, mix)
    dss_sweep_nomerge_cuda.launches += launched
    return out


dss_sweep_nomerge_cuda.launches = 0


def _patch_tables(name, tables: FixTables, dev) -> tuple:
    """Check the tables a patch reads on ``dev`` (fix_lanes, read_lanes and
    read_col [nfix], int32, contiguous, on dev) and return (tables, dev,
    nfix, read_lanes' and read_col's addresses). A FixTables and its tensors
    never change, so each tables object is checked once a device
    (``_patch_tables_ok`` keeps what passed)."""
    n = tables.nfix
    for op, t, shape in (("fix_lanes", tables.fix_lanes, (n,)),
                         ("read_lanes", tables.read_lanes, (n,)),
                         ("read_col", tables.read_col, (n,))):
        if t.shape != shape:
            raise ValueError(f"{name}: {op} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name}: {op} is {t.dtype} on {t.device}, "
                             f"expected {torch.int32} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {op} must be contiguous")
    hit = (tables, dev, n, tables.read_lanes.data_ptr(),
           tables.read_col.data_ptr())
    _patch_tables_ok[id(tables)] = hit
    return hit


_patch_tables_ok = {}     # id(FixTables) -> what _patch_tables returned
_patch_launch = None      # the ctypes dss_patch_launch, found at first use


def _patch(name, w, vd, tables: FixTables, mix, taller: bool) -> bool:
    """Check and run one patch of the first k = vd.shape[0] rows of w (w and
    a mix field of exactly k rows unless ``taller``); True where it launched
    the kernel. The patch moves ~3 MB a few times a ring step, so its host
    time is what a caller sees: the operand checks are straight-line
    comparisons and the tables' are made once a tables object and device
    (``_patch_tables``)."""
    global _patch_launch
    if mix is None:
        mx, ca, cb = None, 0.0, 0.0
    else:
        mx, ca, cb = mix
        if isinstance(ca, torch.Tensor) or isinstance(cb, torch.Tensor):
            raise TypeError(f"{name}: the mix coefficients must be numbers, "
                            "not tensors")
    e16, ws, vs = tables.e16, w.shape, vd.shape
    k = vs[0]
    if len(ws) != 2 or ws[1] != e16 or ws[0] < k or (ws[0] != k
                                                     and not taller):
        raise ValueError(f"{name}: w must be [{'>= ' * taller}{k}, {e16}], "
                         f"got {tuple(ws)}")
    if mx is not None:
        ms = mx.shape
        if len(ms) != 2 or ms[1] != e16 or ms[0] < k or (ms[0] != k
                                                         and not taller):
            raise ValueError(f"{name}: the mix field must be "
                             f"[{'>= ' * taller}{k}, {e16}], got {tuple(ms)}")
    cuda, dtype, dev = w.is_cuda, w.dtype, w.device
    if not cuda and not w.is_cpu:
        raise ValueError(f"{name}: unsupported device {dev}")
    if dtype is not torch.float32 and dtype is not torch.float64:
        raise TypeError(f"{name}: needs float fields, got {dtype}")
    if cuda and dtype is not torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 only")
    hit = _patch_tables_ok.get(id(tables))
    if hit is None or hit[0] is not tables or hit[1] != dev:
        hit = _patch_tables(name, tables, dev)
    n = hit[2]
    if len(vs) != 2 or vs[1] != n:
        raise ValueError(f"{name}: vd has shape {tuple(vs)}, expected "
                         f"{(k, n)}")
    if vd.device != dev or vd.dtype is not dtype:
        raise ValueError(f"{name}: vd is {vd.dtype} on {vd.device}, expected "
                         f"{dtype} on {dev}")
    if mx is not None and (mx.device != dev or mx.dtype is not dtype):
        raise ValueError(f"{name}: the mix field is {mx.dtype} on "
                         f"{mx.device}, expected {dtype} on {dev}")
    if not (w.is_contiguous() and vd.is_contiguous()
            and (mx is None or mx.is_contiguous())):
        op = ("w" if not w.is_contiguous() else
              "vd" if not vd.is_contiguous() else "the mix field")
        raise ValueError(f"{name}: {op} must be contiguous")
    wp, vp = w.data_ptr(), vd.data_ptr()
    wend = wp + w.nbytes
    if wp < vp + vd.nbytes and vp < wend:
        raise ValueError(f"{name}: w overlaps vd")
    mp = 0 if mx is None else mx.data_ptr()
    if mp and wp < mp + mx.nbytes and mp < wend:
        raise ValueError(f"{name}: w overlaps the mix field")
    if not cuda:
        _patch_plain(w, vd, tables.fix_lanes, mix)
        return False
    if _patch_launch is None:
        _patch_launch = _build.library("dss").dss_patch_launch
    index = dev.index
    err = _patch_launch(wp, vp, hit[3], hit[4], n, mp, ca, cb, k, e16,
                        torch._C._cuda_getCurrentRawStream(index), index)
    if err:
        _build.check_launch("dss", err)
    return True


def dss_merge_patch_cuda(w: torch.Tensor, vd: torch.Tensor,
                         tables: FixTables, mix=None) -> torch.Tensor:
    """IN PLACE on w [k, E16]: each fix lane takes its fixup value from vd
    [k, nfix], or with ``mix=(mx, ca, cb)`` (mx of w's shape) ca*mx + cb*vd;
    every other lane keeps its bits (kernel ``dss_patch``, counterpart of
    ``merge_patch_pallas``). w must not overlap vd or mx. Returns w."""
    dss_merge_patch_cuda.launches += _patch("dss_merge_patch", w, vd, tables,
                                            mix, taller=False)
    return w


dss_merge_patch_cuda.launches = 0


def dss_structured_t_cuda(x: torch.Tensor, plan, rsp: torch.Tensor,
                          mix=None):
    """rspheremp * DSS(x) for a transposed [k, E16] field: extract, fixup,
    sweep (counterpart of ``dss_structured_t_pallas``). rsp is [1, E16] or
    the two-float [2, E16]; ``mix`` as in ``dss_sweep_cuda``."""
    tables = fix_tables(plan, x.device)
    return dss_structured_t_cuda_pre(x, dss_extract_cuda(x, tables), plan,
                                     rsp, mix)


def dss_structured_t_cuda_pre(x: torch.Tensor, slab: torch.Tensor, plan,
                              rsp: torch.Tensor, mix=None):
    """``dss_structured_t_cuda`` with the fix-lane slab of x already in hand
    (the slab output of the CAAR or the weak-Laplacian kernel; counterpart
    of ``dss_structured_t_pallas_pre`` / ``_cpre``)."""
    tables = fix_tables(plan, x.device)
    return dss_sweep_cuda(x, rsp, dss_fixup_cuda(slab, tables, rsp), tables,
                          mix)


def dss_structured_t_cuda_patch(x: torch.Tensor, slab: torch.Tensor, plan,
                                rsp: torch.Tensor, mix=None):
    """``dss_structured_t_cuda_pre`` as the sweep/patch split (counterpart
    of ``dss_structured_t_pallas_patch``): fixup, merge-free sweep, then the
    patch of the fix lanes; bit for bit the merged form. ``mix`` takes an mx
    of x's height only (as the JAX function, whose patch asserts it): in
    place into a taller mx the sweep would overwrite mx's fix lanes before
    the patch reads them."""
    if mix is not None and tuple(mix[0].shape) != tuple(x.shape):
        raise ValueError(f"dss_structured_t_cuda_patch: mix field must be "
                         f"{tuple(x.shape)}, got {tuple(mix[0].shape)}")
    tables = fix_tables(plan, x.device)
    vd = dss_fixup_cuda(slab, tables, rsp)
    w = dss_sweep_nomerge_cuda(x, rsp, tables, mix)
    return dss_merge_patch_cuda(w, vd, tables, mix)


# -- the multi-device DSS: the banded sweep and the shard-local patch --------

@dataclasses.dataclass(frozen=True)
class BandTables:
    """Static tables of one shard of the band-sharded DSS: ``nchunks`` band
    chunks of ``bl`` lanes (whole element rows of ``rl`` = 16*ne lanes), the
    shard's own fix-lane tables ``fix`` (shard-local lanes, e16 =
    nchunks*bl) and per chunk ``flags`` (int32: bit 0 the first band of its
    face, bit 1 the last), in place of the JAX package's bf16 lane masks."""

    fix: FixTables
    nchunks: int
    bl: int
    flags: torch.Tensor          # [nchunks] int32
    first_last: tuple            # the flags as ((first, last), ...)

    @property
    def rl(self) -> int:
        return self.fix.ne * NPSQ

    @property
    def ext(self) -> int:
        return self.bl + 2 * self.rl


def band_tables(fix: FixTables, bl: int, first_last) -> BandTables:
    """BandTables of a shard's chunks, ``first_last`` one (first, last) pair
    a chunk."""
    first_last = tuple((bool(a), bool(b)) for a, b in first_last)
    flags = torch.tensor([a + 2 * b for a, b in first_last], dtype=torch.int32,
                         device=fix.fix_col.device)
    return BandTables(fix=fix, nchunks=len(first_last), bl=bl, flags=flags,
                      first_last=first_last)


def band_masks(ne: int, bl: int, first_last) -> np.ndarray:
    """The JAX package's four sweep masks (alpha hi / lo, beta hi / lo) of
    the chunks [band | next | prev], [4, nchunks*ext] bool: the counterpart
    of ``maskv`` of ``dist/banded_t4.py``."""
    rl = ne * NPSQ
    lane = np.arange(bl + 2 * rl)
    i, j = (lane // NP) % NP, lane % NP
    ei, lrow = (lane // NPSQ) % ne, lane // rl
    in_band, br = lrow < bl // rl, bl // rl
    out = []
    for first, last in first_last:
        out.append(np.stack([
            (i == NP - 1) & (ei < ne - 1), (i == 0) & (ei > 0),
            (j == NP - 1) & in_band & ~((lrow == br - 1) & last),
            (j == 0) & in_band & ~((lrow == 0) & first)]))
    return np.concatenate(out, axis=1)


def _banded_plain(x_ext, rsp, masks, nchunks, bl, rl, vd=None, col=None,
                  mix=None):
    """The banded sweep as masked rolls inside each chunk (the JAX kernels'
    form): rspheremp * (alpha then beta sum) of each band lane, merged lanes
    (col >= 0) taking vd[:, col]; ``mix`` as ``dss_sweep_plain``. Pure."""
    k, ext = x_ext.shape[0], bl + 2 * rl
    if x_ext.shape[1] != nchunks * ext:
        raise ValueError(f"banded sweep: x_ext must be [k, {nchunks * ext}], "
                         f"got {tuple(x_ext.shape)}")
    x = x_ext.reshape(k, nchunks, ext)
    m = torch.as_tensor(masks, device=x.device).reshape(4, nchunks, ext) != 0
    db = rl - (NP - 1)
    zero = x.new_zeros(())
    part = lambda mk, y, s: torch.where(mk, torch.roll(y, s, 2), zero)
    y = x + part(m[0], x, -NP) + part(m[1], x, NP)
    z = y + part(m[2], y, -db) + part(m[3], y, db)
    w = _scale(z[:, :, :bl].reshape(k, nchunks * bl), rsp[:, None, :])
    if vd is not None:
        col = torch.as_tensor(col, device=x.device).long()
        w = torch.where(col >= 0, vd[:, col.clamp(min=0)], w)
    return _mix_plain("banded sweep", w, w, mix)


def _band_sweep_plain(x_ext, rsp, vd, bt: BandTables, mix=None):
    """The banded sweep in the wrappers' operand form (vd None: merge-free)
    from ``_banded_plain``, the masks built from the chunk flags. Pure."""
    return _banded_plain(x_ext, rsp, band_masks(bt.fix.ne, bt.bl,
                                                bt.first_last),
                         bt.nchunks, bt.bl, bt.rl, vd,
                         None if vd is None else bt.fix.fix_col, mix)


def _patch_plain(w, vd, lanes, mix=None):
    """IN PLACE on the first rows of w: w[:k, lanes] = vd, or with
    ``mix=(mx, ca, cb)`` ca*mx[:k, lanes] + cb*vd. Returns w."""
    k = vd.shape[0]
    lanes = torch.as_tensor(lanes, device=w.device).long()
    if mix is None:
        w[:k, lanes] = vd
    else:
        mx, ca, cb = mix
        w[:k, lanes] = float(ca) * mx[:k, lanes] + float(cb) * vd
    return w


def _tile_lanes(gtiles, width, dmask, pick=None):
    """(lanes, columns) of the merged lanes of 128-lane tiles: tile n of
    ``gtiles`` covers lanes gtiles[n]*128 + c (c < 128, inside ``width``),
    merged where dmask[n*128 + c] is set; its value is column n*128 + c, or
    with ``pick(n, c)`` that column (a one-hot placement), else -1."""
    lanes, cols = [], []
    for n, t in enumerate(gtiles):
        for c in range(min(128, width - t * 128)):
            if dmask[n * 128 + c]:
                lanes.append(t * 128 + c)
                cols.append(n * 128 + c if pick is None else pick(n, c))
    return np.asarray(lanes, np.int64), np.asarray(cols, np.int64)


def _one_hot_rows(p_tbl, ntb, m_rows):
    """pick(n, c): the row r of tile n's placement block with a one at
    column c, as the vals column n*m_rows + r."""
    p = np.asarray(torch.as_tensor(p_tbl).float().cpu()) != 0
    rows = np.full((ntb, 128), -1, np.int64)
    for s in range(ntb):
        r, c = np.nonzero(p[s * m_rows:(s + 1) * m_rows])
        rows[s, c] = r

    def pick(n, c):
        if rows[n % ntb, c] < 0:
            raise ValueError(f"placement table: tile {n} merges lane {c}, "
                             "which no row places")
        return n * m_rows + rows[n % ntb, c]

    return pick


def dss_sweep_banded_plain(x_ext, rsp, vals, dense_mask, masks, tiles,
                           nchunks: int, bl: int, rl: int, mix=None,
                           p_tbl=None, m_rows: int = 0):
    """Plain PyTorch ``dss_sweeps_banded_t`` (``p_tbl`` None: tile-dense
    ``vals`` [k, nchunks*len(tiles)*128]) and ``dss_sweeps_banded_ct``
    (compact ``vals`` [k, nchunks*wr] placed by the one-hot [ntb*m_rows,
    128] ``p_tbl``), at the JAX signature: x_ext [k, nchunks*(bl + 2*rl)];
    rsp [1 or 2, nchunks*bl]; dense_mask [1, nchunks*len(tiles)*128]; masks
    [4, nchunks*ext]. Each merged lane reads its value from its column of
    vals (the one-hot product of the compact form selects one column).
    ``mix=(mx, ca, cb)``: ca*mx + cb*that, a taller mx's further rows kept.
    Pure."""
    ntb, dm = len(tiles), np.asarray(torch.as_tensor(dense_mask).cpu())[0]
    width = vals.shape[1] // nchunks
    pick = None if p_tbl is None else _one_hot_rows(p_tbl, ntb, m_rows)
    col = np.full(nchunks * bl, -1, np.int64)
    for c in range(nchunks):
        lanes, cols = _tile_lanes(tiles, bl, dm[c * ntb * 128:], pick)
        col[c * bl + lanes] = c * width + cols
    return _banded_plain(x_ext, rsp, masks, nchunks, bl, rl, vals, col, mix)


def dss_sweep_banded_nomerge_plain(x_ext, rsp, masks, nchunks: int, bl: int,
                                   rl: int, mix=None):
    """Plain PyTorch ``dss_sweeps_banded_nomerge`` at the JAX signature:
    ``dss_sweep_banded_plain`` without the merge. Pure."""
    return _banded_plain(x_ext, rsp, masks, nchunks, bl, rl, mix=mix)


def dss_patch_tiles_plain(w, vals3, p_tbl, dm_lanes, gtiles, ntb: int,
                          m_rows: int, mix=None):
    """Plain PyTorch ``merge_patch_tiles`` at the JAX signature: the merged
    lanes (``dm_lanes``) of the 128-lane tiles ``gtiles`` of w's first
    k = vals3.shape[2] rows take their value from vals3 [nt, m_rows, k] by
    the one-hot ``p_tbl``, or with ``mix=(mx, ca, cb)`` ca*mx + cb*value.
    Pure: returns a new tensor of w's shape."""
    dm = np.asarray(torch.as_tensor(dm_lanes).cpu())[0]
    lanes, cols = _tile_lanes(gtiles, w.shape[1], dm,
                              _one_hot_rows(p_tbl, ntb, m_rows))
    vd = vals3.reshape(-1, vals3.shape[2]).T
    return _patch_plain(w.clone(), vd[:, torch.from_numpy(cols)], lanes, mix)


def band_layout(ne: int, bl: int, nchunks: int) -> tuple:
    """The layout facts the banded sweep kernel's float4 groups rely on,
    checked: ``bl`` is whole element rows (a positive multiple of rl =
    16*ne, hence of 16, so no aligned group of 4 lanes straddles a chunk)
    and a chunk's x_ext span ext = bl + 2*rl is too (a multiple of 4 lanes,
    so every x_ext row and every chunk in it starts 16-byte aligned).
    Returns (lanes, ext); raises where a fact fails."""
    rl = NPSQ * ne
    if ne < 1 or nchunks < 1 or bl < rl or bl % rl:
        raise ValueError(f"banded sweep: bl={bl} is not a positive multiple "
                         f"of the element row's {rl} lanes (ne={ne}), or "
                         f"{nchunks} chunks")
    ext = bl + 2 * rl
    assert bl % 16 == 0 and ext % 4 == 0
    return nchunks * bl, ext


def _check_band(name, x_ext, rsp, vd, bt: BandTables, mix):
    """Operand checks of the banded sweep; returns (device, mx, ca, cb,
    in_place)."""
    k, lanes = x_ext.shape[0], bt.nchunks * bt.bl
    _check_rsp(name, rsp, lanes)
    ops = {"x_ext": (x_ext, (k, bt.nchunks * bt.ext)),
           "rsp": (rsp, tuple(rsp.shape))}
    if vd is not None:
        ops.update({"vd": (vd, (k, bt.fix.nfix)),
                    "fix_col": (bt.fix.fix_col, (lanes,))})
    mx, ca, cb = None, 0.0, 0.0
    if mix is not None:
        mx, ca, cb = mix
        if mx.ndim != 2 or mx.shape[1] != lanes or mx.shape[0] < k:
            raise ValueError(f"{name}: mix field must be [>= {k}, {lanes}], "
                             f"got {tuple(mx.shape)}")
        ops["mix field"] = (mx, tuple(mx.shape))
        ca, cb = float(ca), float(cb)
    dev = _check(name, ops, dtype=x_ext.dtype)
    if bt.flags.device != dev or bt.flags.dtype != torch.int32 \
            or tuple(bt.flags.shape) != (bt.nchunks,):
        raise ValueError(f"{name}: flags must be int32 [{bt.nchunks}] on "
                         f"{dev}")
    in_place = mx is not None and mx.shape[0] > k
    if in_place and _overlap(mx, x_ext):
        raise ValueError(f"{name}: the in-place mix field overlaps x_ext")
    return dev, mx, ca, cb, in_place


def _sweep_banded(name, x_ext, rsp, vd, bt: BandTables, mix):
    """Check and run one banded sweep (vd None: merge-free). Returns (out,
    launched)."""
    dev, mx, ca, cb, in_place = _check_band(name, x_ext, rsp, vd, bt, mix)
    k, lanes = x_ext.shape[0], bt.nchunks * bt.bl
    if dev.type == "cpu":
        if not in_place:
            return _band_sweep_plain(x_ext, rsp, vd, bt, mix), False
        mx[:k] = _band_sweep_plain(x_ext, rsp, vd, bt, (mx[:k], ca, cb))
        return mx, False
    if not 1 <= k <= _MAX_ROWS:
        raise ValueError(f"{name}: {k} rows outside the grid's 1.."
                         f"{_MAX_ROWS}")
    band_layout(bt.fix.ne, bt.bl, bt.nchunks)
    out = mx if in_place else x_ext.new_empty(k, lanes)
    # the kernel reads and writes 16-byte groups of lanes
    for op, t in (("x_ext", x_ext), ("rsp", rsp), ("mix field", mx),
                  ("out", out),
                  ("fix_col", None if vd is None else bt.fix.fix_col)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {op} must be 16-byte aligned")
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = _build.library("dss").dss_sweep_banded_launch(
        x_ext.data_ptr(), rsp.data_ptr(), rsp.shape[0], ptr(vd),
        bt.fix.nfix, 0 if vd is None else bt.fix.fix_col.data_ptr(),
        bt.flags.data_ptr(), ptr(mx), ca, cb, out.data_ptr(), k, lanes,
        bt.bl, bt.nchunks, bt.fix.ne, _stream(dev), dev.index)
    _build.check_launch("dss", err)
    return out, True


def dss_sweep_banded_cuda(x_ext: torch.Tensor, rsp: torch.Tensor,
                          vd: torch.Tensor, tables: BandTables,
                          mix=None) -> torch.Tensor:
    """The banded sweep of one shard (kernel ``dss_sweep_banded``,
    counterpart of ``dss_sweeps_banded_t`` / ``_ct``): x_ext [k,
    nchunks*ext] the shard's chunks each followed by its next and previous
    element rows; rsp [1 or 2, nchunks*bl]; vd [k, nfix] the values of the
    shard's fix lanes (``tables.fix.fix_col``). Returns the assembled
    [k, nchunks*bl], a new tensor, or with ``mix=(mx, ca, cb)`` ca*mx +
    cb*assembled; a TALLER mx is updated IN PLACE in its first k rows and
    returned (it must not overlap x_ext)."""
    out, launched = _sweep_banded("dss_sweep_banded", x_ext, rsp, vd, tables,
                                  mix)
    dss_sweep_banded_cuda.launches += launched
    return out


dss_sweep_banded_cuda.launches = 0


def dss_sweep_banded_nomerge_cuda(x_ext: torch.Tensor, rsp: torch.Tensor,
                                  tables: BandTables,
                                  mix=None) -> torch.Tensor:
    """The banded sweep with the merge off (kernel ``dss_sweep_banded``,
    counterpart of ``dss_sweeps_banded_nomerge``): every band lane, fix
    lanes included, gets rspheremp times its in-face sum, for
    ``dss_patch_tiles_cuda`` to complete; output and ``mix`` as
    ``dss_sweep_banded_cuda``."""
    out, launched = _sweep_banded("dss_sweep_banded_nomerge", x_ext, rsp,
                                  None, tables, mix)
    dss_sweep_banded_nomerge_cuda.launches += launched
    return out


dss_sweep_banded_nomerge_cuda.launches = 0


def dss_patch_tiles_cuda(w: torch.Tensor, vd: torch.Tensor, tables: FixTables,
                         mix=None) -> torch.Tensor:
    """IN PLACE on the first k rows of w [>= k, e16]: each fix lane of the
    shard (``tables.fix_lanes``) takes its value from vd [k, nfix], or with
    ``mix=(mx, ca, cb)`` (mx [>= k, e16]) ca*mx + cb*that; every other
    element of w keeps its bits (kernel ``dss_patch``, counterpart of
    ``merge_patch_tiles``). w must not overlap vd or mx. Returns w."""
    dss_patch_tiles_cuda.launches += _patch("dss_patch_tiles", w, vd, tables,
                                            mix, taller=True)
    return w


dss_patch_tiles_cuda.launches = 0
