"""Ring-fused producer + DSS sweep: one launch computes a step's update and
the rspheremp-scaled alpha/beta sweep of it (counterpart of
``tinman_sandbox_tpu/kernels/ring_fused.py``).

The two-launch path writes the update s1 to device memory and the sweep
kernel reads it back. Here one kernel does both: each block produces one
tile of s1 into a scratch field and flags it, then sweeps the tile ``halo``
tiles behind it once the tiles that sweep reads are flagged (the schedule is
in ``csrc/ring.cuh``). The sweep's expressions are the sweep kernel's
(``csrc/dss_sweep.cuh``), and the producers run the CAAR and Euler kernels'
own code, so every non-fix lane of the output equals the two-launch path's
bit for bit. The cube-edge and corner lanes hold in-face partial sums: the
fixup and the patch (``kernels/dss.py``) complete the DSS.

  * ``caar_ring_packed_t4`` (kernel ``caar_ring_kernel`` in ``csrc/caar.cu``,
    replaces ``caar_ring_packed_t4``, ring_fused.py:189): the CAAR step on
    stacked [4*nlev, E16] states, pair or stage mode (``single``,
    ``emit_phi``), the sweep's ``mix`` epilogue, the accumulators IN PLACE
    and the fix-lane slab [nfix, 4*nlev]; in the pair form sm1, qdp and
    pecnd may be bf16 (``caar_t.STORAGE``; the CAAR kernel's storage
    instances, counted also in ``caar_ring_packed_t4.storage_launches``);
    its stage mode takes float32 only, as does ``tracer_ring_packed_t``:
    no entry point of the JAX package hands its ring forms bf16.
    Its tiles are the chunked CAAR kernel's 32 columns (``ring_plan``: the producer's plan, the halo and
    the schedule), its sweep runs on float4 groups, and each tile's s1
    lines are discarded from L2 once its last reader is done.
    ``caar_ring_plain`` is ``caar_t4_plain(fix=)`` followed by
    ``dss_sweep_nomerge_plain(mix=)``.
  * ``tracer_ring_packed_t`` (``tracer_ring_kernel`` in ``csrc/tracer.cu``,
    replaces ``tracer_ring_packed_t``, :369): sph*(q - dt*div(v q)) on the
    stacked [qsize*nlev, E16] tracers, swept, with ``mix`` and the slab.
    Its items are (row block, tile) pairs, a row block some level chunks
    of some tracers, on 128 lanes (``tracer_ring_plan``); its sweep runs on
    float4 groups, and each tile's s1 lines are discarded from L2 once its
    last reader is done, as in the CAAR ring. ``tracer_ring_plain`` is
    ``tracer_euler_plain(fold_sph=True, fix=)`` followed by the merge-free
    sweep.

Each wrapper checks its operands, runs the plain version for CPU tensors
(the accumulators then updated in place too) and launches its kernel for
CUDA float32 tensors, one kernel a call with no host sync, counted in
``<wrapper>.launches``. The scratch s1 is a full-size field from PyTorch's
allocator (its lines live in L2 between their store and their discard), and
so is each call's launch state, [ticket counter | reader counts | flags],
which the launch clears with a stream-ordered memset: two calls on two
streams never share it, and a CUDA graph of either ring replays correctly
(the capture takes its buffers from the graph's private pool).

``ring_geometry(ne, tile)`` is the GPU analog of the JAX function: the beta
shift db = 16*ne - 3 and the halo, the tiles one tile's sweep reads on each
side (an output lane reads x up to db + 4 lanes away: 4 tiles of 128 lanes
at ne30, 16 of the CAAR ring's 32). The JAX kernel's grouped emission
window (``_emit_group``, :72-103) works around the TPU's vector unit and has
no counterpart; nor do its limits: the port takes odd ne and any E16 (the
CAAR ring a multiple of its tile, as every cubed sphere's 96*ne^2 is).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import NP, NPSQ
from ..constants import CONSTANTS
from . import _build
from .caar_t import _BF16, RING_TILE
from .caar_t import _check as _caar_check
from .caar_t import _new_slab as _caar_slab
from .caar_t import _storage as _caar_storage
from .caar_t import CaarPlan, caar_ring_plan, caar_t4_cuda, caar_t4_plain
from .dss import (FixTables, _check_rsp, _overlap, _stream,
                  dss_sweep_nomerge_plain)
from .tracer_t import _check as _tracer_check
from .tracer_t import _check_aligned as _tracer_aligned
from .tracer_t import _new_slab as _tracer_slab
from .tracer_t import tracer_euler_cuda, tracer_euler_plain

__all__ = ["RingGeometry", "ring_geometry", "RingPlan", "ring_plan",
           "TracerRingPlan", "tracer_ring_plan", "caar_ring_plain",
           "caar_ring_packed_t4", "tracer_ring_plain",
           "tracer_ring_packed_t"]

TILE = 128          # lanes a tracer ring block produces and sweeps
                    # (csrc/tracer.cu kTile)
# tickets between a tile's producer and its sweep beyond the halo: on the
# H100 a lag of 128 left the sweeps' waits the least to spin on, and the
# tiles they read still in L2 (experiments/kernel_variants.py ring)
RING_LAG = 128
# the tracer ring's lag (experiments/kernel_variants.py tracer_ring)
TRACER_RING_LAG = 128
_LEVELS = 8          # levels of one tracer row chunk (csrc/tracer.cu kLevels)
# the rows (tracers x levels) of a tracer ring item: chunks of every tracer
# are grouped up to the first, and a chunk of every tracer with more rows
# than the second is split into tracer groups of at most that many
# (experiments/kernel_variants.py tracer_ring)
TRACER_RING_ITEM_ROWS = (24, 72)
# the lane multiple the tracer ring takes: a tile's row of s1 is whole
# 128-byte lines, which its last reader discards from L2
TRACER_RING_LANES = 32


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """The sweep's reach on the lane axis at one ne: the beta shift ``db``,
    the farthest lane an output lane reads (``reach`` = db + NP) and the
    ``halo`` of tiles of ``tile`` lanes it spans on each side."""

    db: int
    reach: int
    halo: int
    tile: int


def ring_geometry(ne: int, tile: int = TILE) -> RingGeometry:
    """The ring's geometry at cubed-sphere ne for tiles of ``tile`` lanes."""
    db = NPSQ * ne - (NP - 1)
    reach = db + NP
    return RingGeometry(db=db, reach=reach, halo=-(-reach // tile), tile=tile)


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """The CAAR ring kernel's launch at (ncol, nlev, ne) and its schedule
    (``csrc/ring.cuh``): the producer's plan ``caar`` (``caar_ring_plan``:
    tile, chunks, levels, stash), the sweep's geometry ``geo`` on that tile
    and the ``lag``. The block with ticket t < ``nb`` produces tile t; every
    block with t >= halo + lag sweeps tile t - halo - lag after waiting on
    ``waits(t)`` (all tiles below its own ticket: the lag lets them finish
    first), then counts itself a reader of those tiles; the count that
    reaches ``readers(u)`` retires tile u (its s1 lines leave L2
    unwritten)."""

    caar: CaarPlan
    geo: RingGeometry
    lag: int = 0

    @property
    def nb(self) -> int:
        return self.caar.ncol // self.caar.tile

    @property
    def tickets(self) -> int:
        """Blocks of the launch."""
        return self.nb + self.geo.halo + self.lag

    def sweeps(self, t: int):
        """The tile the block of ticket t sweeps, or None."""
        j = t - self.geo.halo - self.lag
        return j if j >= 0 else None

    def waits(self, t: int) -> range:
        """The tiles the block of ticket t waits on (and counts as read):
        the swept tile's j - halo .. j + halo inside 0 .. nb-1."""
        j = self.sweeps(t)
        if j is None:
            return range(0)
        return range(max(j - self.geo.halo, 0),
                     min(j + self.geo.halo, self.nb - 1) + 1)

    def readers(self, u: int) -> int:
        """The sweeps that count tile u as read."""
        h = self.geo.halo
        return min(u + h, self.nb - 1) - max(u - h, 0) + 1


def ring_plan(ncol: int, nlev: int, ne: int, tile: int = RING_TILE,
              lag: int = RING_LAG) -> RingPlan:
    """The CAAR ring kernel's plan at (ncol, nlev) on cubed-sphere ne, the
    one the wrapper launches. Raises on the shapes the launch refuses:
    those ``caar_ring_plan`` refuses (nlev outside 1..400, a column count
    that is not a positive multiple of the tile, shared memory), ne < 1 and
    a negative lag. Its halo covers the sweep's reach by construction; its
    wait takes any halo (a thread a flag, in turns of the block)."""
    if ne < 1 or lag < 0:
        raise ValueError(f"caar_ring: ne={ne} < 1 or lag={lag} < 0")
    return RingPlan(caar=caar_ring_plan(ncol, nlev, tile),
                    geo=ring_geometry(ne, tile), lag=lag)


@dataclasses.dataclass(frozen=True)
class TracerRingPlan:
    """The tracer ring kernel's launch at (ncol, nlev, qsize, ne) and its
    schedule (``csrc/ring.cuh``): ``items`` = ``blocks`` x ``nb`` (row
    block, tile) pairs, row-block-major, a row block ``group`` chunks of 8
    levels (_LEVELS) of ``tracers`` tracers (for each level group, its
    tracer groups in order) on TILE lanes; the sweep's geometry ``geo`` and the
    ``lag``. The block with ticket t < ``items`` produces item t
    (``produces``); every block with an item at t - halo - lag sweeps it
    (``sweeps``) after waiting on ``waits(t)`` (its row block's tiles j -
    halo .. j + halo, all of lower tickets), then counts itself a reader
    of those tiles; the count that reaches ``readers(u)`` retires tile u of
    the row block. ``state`` ints of launch state: the ticket counter, a
    reader count and a flag an item."""

    ncol: int
    nlev: int
    geo: RingGeometry
    lag: int = 0
    group: int = 1
    tracers: int = 1
    qsize: int = 1

    @property
    def nb(self) -> int:
        return -(-self.ncol // TILE)

    @property
    def chunks(self) -> int:
        return -(-self.nlev // _LEVELS)

    @property
    def blocks(self) -> int:
        """Row blocks: level groups x tracer groups."""
        return -(-self.nlev // (_LEVELS * self.group)) * \
            -(-self.qsize // self.tracers)

    @property
    def items(self) -> int:
        return self.blocks * self.nb

    @property
    def tickets(self) -> int:
        """Blocks of the launch."""
        return self.items + self.geo.halo + self.lag

    @property
    def state(self) -> int:
        return 1 + 2 * self.items

    def produces(self, t: int):
        """(row block, tile) that the block of ticket t produces, or
        None."""
        return divmod(t, self.nb) if 0 <= t < self.items else None

    def sweeps(self, t: int):
        """(row block, tile) that the block of ticket t sweeps, or None."""
        return self.produces(t - self.geo.halo - self.lag)

    def waits(self, t: int):
        """(row block, range of tiles) that the block of ticket t waits on
        (and counts as read): the swept tile's j - halo .. j + halo inside
        its row block; None where it sweeps nothing."""
        item = self.sweeps(t)
        if item is None:
            return None
        c, j = item
        h = self.geo.halo
        return c, range(max(j - h, 0), min(j + h, self.nb - 1) + 1)

    def readers(self, u: int) -> int:
        """The sweeps of tile u's row block that count tile u as read."""
        h = self.geo.halo
        return min(u + h, self.nb - 1) - max(u - h, 0) + 1


def tracer_ring_plan(ncol: int, nlev: int, ne: int, qsize: int = 1,
                     lag: int = TRACER_RING_LAG) -> TracerRingPlan:
    """The tracer ring kernel's plan at (ncol, nlev, qsize) on cubed-sphere
    ne, the one the wrapper launches, a pure function of the shape: with
    (group_rows, split_rows) = TRACER_RING_ITEM_ROWS, an item is as many
    chunks of every tracer as fit group_rows rows (three at qsize 1), or
    one chunk of every tracer (up to split_rows rows), or one chunk of the
    fewest tracers in equal groups that keep it to split_rows (9 and 8 at
    qsize 35). Raises on
    the shapes the launch refuses: nlev or qsize < 1, a lane count that is
    not a positive multiple of TRACER_RING_LANES (every cubed sphere's
    96*ne^2 is one), ne < 1 and a negative lag. Its halo covers the sweep's
    reach by construction; its wait takes any halo."""
    if ne < 1 or lag < 0 or nlev < 1 or qsize < 1:
        raise ValueError(f"tracer_ring: ne={ne} < 1, lag={lag} < 0, "
                         f"nlev={nlev} < 1 or qsize={qsize} < 1")
    if ncol < TRACER_RING_LANES or ncol % TRACER_RING_LANES:
        raise ValueError(f"tracer_ring: ncol={ncol} is not a positive "
                         f"multiple of {TRACER_RING_LANES}")
    chunks = -(-nlev // _LEVELS)
    group_rows, split_rows = TRACER_RING_ITEM_ROWS
    group, tracers = 1, qsize
    if _LEVELS * qsize <= group_rows:
        group = min(chunks, group_rows // (_LEVELS * qsize))
    elif _LEVELS * qsize > split_rows:
        tracers = -(-qsize // -(-_LEVELS * qsize // split_rows))
    return TracerRingPlan(ncol=ncol, nlev=nlev, geo=ring_geometry(ne),
                          lag=lag, group=group, tracers=tracers, qsize=qsize)


def _new_state(ref: torch.Tensor, n: int) -> torch.Tensor:
    """A launch's state, [ticket counter | reader counts | flags], n int32
    on ref's device from PyTorch's allocator on the current stream (under
    CUDA-graph capture from the graph's pool): a new buffer each call,
    which the launch clears."""
    return ref.new_empty(n, dtype=torch.int32)


def _check_ring(name, x, rsp, fix: FixTables, mix):
    """The ring operands beside the producer's: rsp, the tables and the mix
    field (of x's shape, never an output). Returns (mx, ca, cb)."""
    e16 = x.shape[1]
    _check_rsp(name, rsp, e16)
    if fix.e16 != e16:
        raise ValueError(f"{name}: the tables are for E16 = {fix.e16}, the "
                         f"field has {e16}")
    for op, t in (("rsp", rsp),) + (() if mix is None else
                                    (("mix field", mix[0]),)):
        if t.device != x.device or t.dtype != x.dtype or \
                not t.is_contiguous():
            raise ValueError(f"{name}: {op} must be a contiguous {x.dtype} "
                             f"tensor on {x.device}")
    if mix is None:
        return None, 0.0, 0.0
    mx, ca, cb = mix
    if tuple(mx.shape) != tuple(x.shape):
        raise ValueError(f"{name}: mix field must be {tuple(x.shape)}, got "
                         f"{tuple(mx.shape)}")
    return mx, float(ca), float(cb)


def caar_ring_plain(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                    rsp, fix: FixTables, moist: bool = True,
                    single: bool = False, emit_phi: bool = True, mix=None):
    """Plain PyTorch ``caar_ring_packed_t4``: ``caar_t4_plain`` with the
    slab, then the merge-free sweep of s1 (with ``mix``). Pure: returns new
    (w, phi, vn0u', vn0v', omg', slab)."""
    s1, phi, *acc, slab = caar_t4_plain(
        scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv, moist=moist,
        fix=fix, single=single, emit_phi=emit_phi)
    return (dss_sweep_nomerge_plain(s1, rsp, fix, mix), phi, *acc, slab)


def caar_ring_packed_t4(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg,
                        dvv, rsp, fix: FixTables, moist: bool = True,
                        single: bool = False, emit_phi: bool = True,
                        mix=None):
    """The ring-fused CAAR step (counterpart of ``caar_ring_packed_t4``):
    operands and modes as ``caar_t4_cuda`` with ``fix`` (required: the slab
    feeds the fixup), plus rsp [1 or 2, E16] and ``mix=(mx, ca, cb)`` with
    mx of s0's shape. The accumulators are updated IN PLACE. Returns (w,
    phi, vn0u, vn0v, omg, slab): w = rspheremp * the in-face sweep of s1 (or
    ca*mx + cb*that), its fix lanes partial; phi None without
    ``emit_phi``."""
    k = qdp.shape[0]
    if not single and sm1 is None:
        raise ValueError("caar_ring: sm1 is required unless single=True")
    if not single and not emit_phi:
        raise ValueError("caar_ring: emit_phi=False needs single=True")
    if s0.shape[0] != 4 * k or (not single and sm1.shape[0] != 4 * k):
        raise ValueError(f"caar_ring: s0/sm1 need {4 * k} rows")
    mx, ca, cb = _check_ring("caar_ring", s0, rsp, fix, mix)
    dev = _caar_check(scal, meta, dvv, (vn0u, vn0v, omg), k, states=(s0,),
                      aux=(qdp, pecnd), nm1=None if single else sm1)
    if single and _BF16 in (qdp.dtype, pecnd.dtype):
        raise ValueError(f"caar_ring: qdp is {qdp.dtype} and pecnd "
                         f"{pecnd.dtype} in the stage mode (sm1=None), which "
                         "the ring takes in float32 only (no JAX entry point "
                         "hands its ring stage bf16)")
    if dev.type == "cpu":
        s1, phi, *acc, slab = caar_t4_cuda(
            scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
            moist=moist, fix=fix, single=single, emit_phi=emit_phi)
        return (dss_sweep_nomerge_plain(s1, rsp, fix, mix), phi, *acc, slab)
    # raises where the kernel refuses
    plan = ring_plan(s0.shape[1], k, fix.ne)
    for name, acc in (("vn0u", vn0u), ("vn0v", vn0v), ("omg", omg)):
        if mx is not None and _overlap(mx, acc):
            raise ValueError(f"caar_ring: the mix field overlaps {name}")
    scratch = torch.empty_like(s0)     # the launch refuses it unless
    w = torch.empty_like(s0)           # 128-byte aligned (whole L2 lines)
    # the sweep moves 16-byte groups
    for op, t in (("rsp", rsp), ("mix field", mx), ("w", w)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"caar_ring: {op} must be 16-byte aligned")
    phi = s0.new_empty(qdp.shape) if emit_phi else None
    slab = _caar_slab(fix, s0, k)
    storage = _caar_storage((qdp, pecnd), None if single else sm1)
    state = _new_state(s0, 1 + 2 * plan.nb)
    ptr = lambda x: 0 if x is None else x.data_ptr()
    c = CONSTANTS
    base = (None,) * 4 if single else sm1.split(k)
    err = _build.library("caar").caar_ring_launch(
        ptr(scal), ptr(meta), ptr(dvv), *map(ptr, s0.split(k)),
        *map(ptr, base), ptr(qdp), ptr(pecnd), ptr(vn0u), ptr(vn0v),
        ptr(omg), ptr(scratch), ptr(phi), ptr(fix.fix_rank), ptr(slab),
        ptr(rsp), ptr(mx), ptr(w), ptr(state), state.numel(), k, s0.shape[1],
        int(bool(moist)), rsp.shape[0], fix.ne, plan.geo.halo, plan.lag,
        plan.caar.tile, plan.caar.chunks, plan.caar.levels,
        int(plan.caar.stash), storage, c.Rgas, c.kappa, c.rgas_over_rvap_m1,
        c.rrearth, ca, cb, _stream(dev), dev.index)
    _build.check_launch("caar", err)
    caar_ring_packed_t4.launches += 1
    caar_ring_packed_t4.storage_launches += qdp.dtype == _BF16
    return w, phi, vn0u, vn0v, omg, slab


caar_ring_packed_t4.launches = 0
caar_ring_packed_t4.storage_launches = 0


def tracer_ring_plain(meta, vu, vv, q, dvv, dt, nlev: int, rsp,
                      fix: FixTables, wind_rows=(0, 0), mix=None):
    """Plain PyTorch ``tracer_ring_packed_t``: ``tracer_euler_plain`` with
    spheremp folded in and the slab, then the merge-free sweep. Pure:
    returns (w, slab)."""
    e, slab = tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev,
                                 fold_sph=True, wind_rows=wind_rows, fix=fix)
    return dss_sweep_nomerge_plain(e, rsp, fix, mix), slab


def tracer_ring_packed_t(meta, vu, vv, q, dvv, dt, nlev: int, rsp,
                         fix: FixTables, wind_rows=(0, 0), mix=None):
    """The ring-fused Euler stage (counterpart of ``tracer_ring_packed_t``):
    operands as ``tracer_euler_cuda`` (winds at the row blocks
    ``wind_rows``), plus rsp [1 or 2, E16], the tables ``fix`` and
    ``mix=(mx, ca, cb)`` with mx of q's shape. Returns (w, slab): w =
    rspheremp * the in-face sweep of sph*(q - dt*div(v q)) (or ca*mx +
    cb*that), its fix lanes partial; slab [nfix, qsize*nlev]."""
    dev = _tracer_check("tracer_ring", meta, vu, vv, q, dvv, nlev, wind_rows)
    mx, ca, cb = _check_ring("tracer_ring", q, rsp, fix, mix)
    if dev.type == "cpu":
        e, slab = tracer_euler_cuda(meta, vu, vv, q, dvv, dt, nlev,
                                    fold_sph=True, wind_rows=wind_rows,
                                    fix=fix)
        return dss_sweep_nomerge_plain(e, rsp, fix, mix), slab
    e16 = q.shape[1]
    # raises where the launch refuses
    plan = tracer_ring_plan(e16, nlev, fix.ne, q.shape[0] // nlev)
    rank, slab = _tracer_slab("tracer_ring", fix, q, q.dtype)
    scratch = torch.empty_like(q)      # the launch refuses it unless
    w = torch.empty_like(q)            # 128-byte aligned (whole L2 lines)
    # the producer and the sweep read and write float4s (csrc/tracer.cu)
    _tracer_aligned("tracer_ring", e16, meta=meta, dvv=dvv, q=q, w=w,
                    rsp=rsp, mix=mx, vu=(vu, wind_rows[0] * nlev * e16),
                    vv=(vv, wind_rows[1] * nlev * e16),
                    fix_rank=fix.fix_rank)
    state = _new_state(q, plan.state)
    err = _build.library("tracer").tracer_ring_launch(
        meta.data_ptr(), dvv.data_ptr(), vu.data_ptr(), vv.data_ptr(),
        q.data_ptr(), scratch.data_ptr(), rank, slab.data_ptr(),
        rsp.data_ptr(), 0 if mx is None else mx.data_ptr(), w.data_ptr(),
        state.data_ptr(), state.numel(), nlev, q.shape[0] // nlev, e16,
        wind_rows[0], wind_rows[1], rsp.shape[0], fix.ne, plan.geo.halo,
        plan.group, plan.tracers, plan.lag, float(dt), CONSTANTS.rrearth, ca,
        cb, _stream(dev), dev.index)
    _build.check_launch("tracer", err)
    tracer_ring_packed_t.launches += 1
    return w, slab


tracer_ring_packed_t.launches = 0
