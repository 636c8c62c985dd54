"""The CAAR step on the packed [nlev, E16] layout (counterpart of
``tinman_sandbox_tpu/kernels/caar_pallas_t.py``).

The kernel is ``csrc/caar.cu``. It replaces the Pallas kernels
``caar_pallas_packed_t4_lg`` (caar_pallas_t.py:542, the bench headline),
``caar_pallas_packed_t`` (:349), ``caar_pallas_packed_t4`` (:405) and the
Runge-Kutta stage kernel ``caar_pallas_packed_t4_rk`` (:740), which all run
``_caar_physics`` (:59-133) plus the accumulator update (:525-527), and in
its rsplit=0 mode ``caar_pallas_packed_rsplit0_t`` (:856), which adds the
interface mass flux, the vertical advection of u, v and T, the dp3d
interface stencil and the eta_dot_dpdn accumulator (:265-290, :307, :344).
It is bound by device-memory traffic; the source's note gives its design.
Where the TPU kernel took 128x128 block-diagonal derivative operators and
triangular scan matrices to feed its matrix unit, this one takes the 4x4
``dvv`` and runs the scans as running sums. It splits the level axis into
chunks summed chunk by chunk: ``caar_plan(ncol, nlev)`` (``CaarPlan``) is
its launch, a pure function of the shape whose chunks depend on nlev alone
(``caar_plan(ncol, nlev, r0=True)`` the rsplit=0 mode's),
``caar_ring_plan`` the ring kernel's and ``caar_row_plan`` the row
layout's (``kernels/caar.py``: the same chunks on tiles staged through
shared memory); all refuse the shapes the kernel does not take (on CPU
tensors the plain version takes any).

  * ``caar_t4_plain`` is the same function in plain PyTorch (cumsum and an
    einsum over ``dvv``). The CPU tests use it; on a card only the checks of
    the kernel against it call it.
  * ``caar_t4_cuda`` is the stacked-state entry (rows 1 and 3 of the kernel
    table) and ``caar_packed_t`` the unstacked one (row 2). Both check their
    operands, run the plain version for CPU tensors and launch the kernel
    for CUDA tensors, counted in ``caar_t4_cuda.launches`` (and those with
    a slab output also in ``caar_t4_cuda.slab_launches``). Both write the
    vn0u/vn0v/omg accumulators IN PLACE.
  * With ``fix=`` (the fix-lane tables of ``kernels/dss.py``) both entries
    and ``caar_t4_plain`` also return the pre-DSS s1 at the fix lanes,
    transposed: the slab [nfix, 4*nlev] with ``slab[r] = s1[:, lanes[r]]``
    (rows 1 and 4 of the kernel table in their slab modes; the TPU kernels
    laid it out by 128-lane tiles, here it is one row per fix lane).
  * With ``single=True`` the stacked entry and ``caar_t4_plain`` run the
    Runge-Kutta stage (rows 1 in its ``single`` mode and 5 of the kernel
    table): the base state of the update is the evaluation state s0,
    ``sm1`` is ignored (pass None) and the kernel never fetches it; with
    ``emit_phi=False`` (accepted with ``single`` only) phi is neither
    stored nor returned (None in its place). Such launches are also counted in
    ``caar_t4_cuda.single_launches``.
  * ``caar_packed_rsplit0_t`` is the rsplit=0 step on unstacked buffers
    (row 6 of the kernel table), ``caar_packed_rsplit0_t_plain`` its plain
    version: ``hyb`` [nlev, 2] holds hybi(k) and hybi(k+1), ``etaacc`` the
    eta_dot_dpdn accumulator at interfaces 1..nlev, updated IN PLACE with
    the other three. Its kernel is the chunked body's rsplit=0 mode, which
    forms the dp tendency as (hybi(k+1) - hybi(k))*sdot: within 5e-5 of the
    plain version in f32 and in f64, and bit for bit the row rsplit=0
    kernel on the transposed problem. Its launches count in
    ``caar_packed_rsplit0_t.launches``.
  * ``caar_t`` is the full-state wrapper (``caar_pallas_t``), dispatching on
    ``cfg.rsplit``, and ``run_leapfrog_t`` the production leapfrog loop
    (``run_leapfrog_pallas_t``, rsplit>0 only, as the JAX loop): pack once,
    rotate packed buffers, unpack once.
  * Mixed-precision storage (``pack_problem_t(storage=)``, ``caar_t(
    storage=)``; ``STORAGE``): "f32" (the default), "bf16_aux" (qdp and
    pecnd stored bf16) and "bf16_ro" (also um1, vm1, tm1 and dpm1). Every
    pair-form entry takes such operands as they come: the n0 state, the
    accumulators and meta stay f32 (the state's dtype on the CPU), compute
    and every output too. The kernel reads the bf16 operands itself and
    upcasts them exactly (``csrc/caar.cu``, kSt), so each mode is, bit for
    bit, the f32 mode on the same operands upcast; the plain version
    upcasts them first. Launches in a bf16 mode also count in
    ``<wrapper>.storage_launches``. The stage mode (``single``) takes the
    two mixes the JAX package's full step hands its stage kernel under
    ``bench --prim --storage``: bf16 qdp and pecnd (its first step, and
    every ``--rk`` step), and an f32 qdp beside a bf16 pecnd (later steps:
    the tracers write f32, pecnd stays bf16).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..config import NPSQ, Config
from ..constants import CONSTANTS
from ..device import resolve_device
from ..grid import Geometry, HybridVCoord, dvv_matrix
from ..ops.sphere import full_precision_matmuls
from ..profiling import launch_span
from ..state import Derived, State, uniform
from . import _build
from .layout import META_COLS, pack_field_t, pack_meta_t, unpack_field_t

__all__ = [
    "CaarPlan",
    "caar_chunks",
    "caar_plan",
    "caar_row_plan",
    "caar_ring_plan",
    "caar_t4_plain",
    "caar_t4_cuda",
    "caar_packed_t",
    "caar_packed_rsplit0_t",
    "caar_packed_rsplit0_t_plain",
    "pack_problem_t",
    "random_packed_problem_t",
    "STORAGE",
    "storage_cast",
    "caar_t",
    "run_leapfrog_t",
]

_MC = {name: i for i, name in enumerate(META_COLS)}
# the most levels the kernels take (caar.cu kMaxNlev; a chunk of 50 levels
# at 400)
_MAX_NLEV = 400

# the card and the chunked kernels the plans are for (csrc/caar.cu): the
# H100's SMs, an SM's threads, registers and shared memory, a block's shared
# memory and the 1 KB the system reserves with each block; the chunked
# kernel's largest block and register cap (__launch_bounds__(256, 3)), the
# ring kernel's (8 chunks of RING_TILE columns: the chunked kernel's own at
# 32 columns; 64 registers a thread on the wider tiles of
# experiments/kernel_variants.py); the rsplit=0 kernels' cap is ROW_REGS
SMS = 132
SM_THREADS = 2048
SM_REGS = 65536
SM_SMEM = 233472
SMEM_MAX = 232448
SMEM_RESERVED = 1024
CHUNK_THREADS = 256
CHUNK_REGS = 80
RING_THREADS = 256
RING_REGS = 64
# the level chunks a column is cut into (the last may be shorter), the
# chunked kernel's tile, and the tile of the ring kernel (csrc kRingTile)
CHUNKS = 8
TILE = 32
RING_TILE = 32
# the row kernel (csrc/caar.cu caar_row_kernel, __launch_bounds__(256, 2)):
# its register cap, the shared-memory planes [nlev][TILE] it stages a tile
# through (rsplit>0, rsplit=0) and the staged meta [16][ROW_META_PITCH];
# beyond the planes, the levels of a warp's window and the slots
# [ROW_WINDOW][TILE] a warp holds (rsplit>0, rsplit=0)
ROW_REGS = 128
ROW_PLANES = (9, 11)
ROW_META_PITCH = 33
ROW_WINDOW = 8
ROW_WINDOW_SLOTS = (13, 14)
# the t layout's rsplit=0 kernel takes its 3-blocks-an-SM instance (80
# registers, the stash) where the launch is at least this many waves of 3
# blocks an SM (experiments/kernel_variants.py rsplit0)
R0_WAVES = 4
# the storage contracts of pack_problem_t (caar_pallas_t.py:903) by the code
# the kernels take (csrc/caar.cu kSt): "bf16_aux" stores qdp and pecnd in
# bf16, "bf16_ro" also the four nm1 fields
STORAGE = {"f32": 0, "bf16_aux": 1, "bf16_ro": 2}
# the stage mode's code for an f32 qdp beside a bf16 pecnd (what the JAX
# package's full step hands its stage kernel after the first bf16 step)
STAGE_PECND = 3
_BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class CaarPlan:
    """The launch of the chunked CAAR kernel at (ncol, nlev): blocks of
    ``tile`` columns in ``chunks`` level chunks of ``levels`` levels
    (``threads`` = tile*chunks), with or without the ``stash`` (the input
    fields that passes 2 and 3 read again, kept in shared memory);
    ``smem`` bytes of dynamic shared memory a block (phi [nlev][tile], the
    chunk totals [3][chunks][tile], the stash [5][nlev][tile]), the
    ``blocks_per_sm`` the plan reckons with at the register cap and the
    ``waves`` of its ``blocks``; ``r0`` is the rsplit=0 mode (its kernels
    capped at ROW_REGS, or at ``cap`` registers where set). A ``row`` plan
    (``caar_row_plan``, the row kernel) reads ``stash`` as "staged": the
    tile's fields copied through ROW_PLANES planes and the meta; unstaged,
    phi, the totals and each chunk's window slots."""

    ncol: int
    nlev: int
    tile: int
    chunks: int
    levels: int
    stash: bool = False
    row: bool = False
    r0: bool = False
    cap: int = 0

    @property
    def threads(self) -> int:
        return self.tile * self.chunks

    @property
    def smem(self) -> int:
        if self.row and self.stash:
            return 4 * ((ROW_PLANES[self.r0] * self.nlev + 3 * self.chunks)
                        * self.tile + 16 * ROW_META_PITCH)
        planes = 6 if self.stash else 1
        window = (self.chunks * ROW_WINDOW_SLOTS[self.r0] * ROW_WINDOW
                  if self.row else 0)
        return 4 * (planes * self.nlev + 3 * self.chunks + window) * self.tile

    @property
    def blocks(self) -> int:
        return -(-self.ncol // self.tile)

    @property
    def regs(self) -> int:
        """The register cap of the kernel that runs the plan."""
        if self.cap:
            return self.cap
        if self.row or self.r0:
            return ROW_REGS
        return CHUNK_REGS if self.threads <= CHUNK_THREADS else RING_REGS

    @property
    def blocks_per_sm(self) -> int:
        return min(SM_THREADS // self.threads,
                   SM_REGS // (self.threads * self.regs),
                   SM_SMEM // (self.smem + SMEM_RESERVED))

    @property
    def waves(self) -> float:
        return self.blocks / (SMS * self.blocks_per_sm)

    def level_ranges(self) -> list:
        """[k0, k1) of each chunk, in chunk order."""
        return [(c * self.levels, min(self.nlev, (c + 1) * self.levels))
                for c in range(self.chunks)]


def caar_chunks(nlev: int) -> tuple:
    """(chunks, levels): ``levels`` = ceil(nlev / CHUNKS) levels a chunk and
    as many chunks as that takes (no empty chunk). A function of nlev alone,
    so every launch at one nlev (a shard's, the ring's) sums a column in the
    same order."""
    if not 1 <= nlev <= _MAX_NLEV:
        raise ValueError(f"caar: nlev={nlev} outside the kernel's 1.."
                         f"{_MAX_NLEV} levels")
    levels = -(-nlev // CHUNKS)
    return -(-nlev // levels), levels


@functools.lru_cache(maxsize=None)
def caar_plan(ncol: int, nlev: int, r0: bool = False) -> CaarPlan:
    """The launch plan of the chunked CAAR kernel at (ncol, nlev), a pure
    function of the shape: ``caar_chunks(nlev)``, tiles of TILE = 32
    columns (a warp of two elements a chunk), and the stash wherever it
    leaves at least two blocks an SM (nlev up to 146; above, passes 2 and 3
    re-read their rows from L2, coalesced). With ``r0`` the rsplit=0 mode
    on the t layout (row 6 of the kernel table): the same chunks and stash
    rule at the rsplit=0 kernels' register cap (ROW_REGS: two blocks an
    SM), so the row rsplit=0 kernel (``caar_row_plan(r0=True)``) sums in
    its order; where the stash fits three blocks an SM and the launch is at
    least R0_WAVES waves of them, the instance capped at CHUNK_REGS for
    three (``cap``). The row layout's plan,
    ``caar_row_plan``, takes the same chunks; it has no such re-read (a row
    column is not coalesced), so it stages its tiles through shared memory
    wherever they fit one block (197 levels, 161 at rsplit=0) and above
    that copies each warp's levels a window at a time. Raises on shapes the
    kernel refuses."""
    if ncol < 1 or ncol % NPSQ:
        raise ValueError(f"caar: ncol={ncol} is not a positive multiple of "
                         f"{NPSQ}")
    plan = CaarPlan(ncol, nlev, TILE, *caar_chunks(nlev), stash=True,
                    r0=bool(r0))
    if plan.blocks_per_sm < 2:
        plan = dataclasses.replace(plan, stash=False)
    if plan.smem > SMEM_MAX:
        raise ValueError(f"caar: nlev={nlev} needs {plan.smem} bytes of "
                         f"shared memory a block, over {SMEM_MAX}")
    if r0 and plan.stash:
        three = dataclasses.replace(plan, cap=CHUNK_REGS)
        if three.blocks_per_sm == 3 and three.waves >= R0_WAVES:
            plan = three
    return plan


@functools.lru_cache(maxsize=None)
def caar_row_plan(ncol: int, nlev: int, r0: bool = False) -> CaarPlan:
    """The row kernel's plan at (ncol, nlev) (rows 7 and 8 of the kernel
    table; ``r0`` the rsplit=0 mode): ``caar_plan``'s chunks on tiles of
    TILE columns, so its sums run in the t kernel's order, staged (the
    tile's input spans copied whole into ROW_PLANES[r0] shared-memory
    planes, the outputs written back a line at a time) wherever the planes
    fit one block: up to 197 levels at rsplit>0 and 161 at rsplit=0, two
    blocks an SM up to 95 and 78. Above that (the t form's no-stash plan
    re-reads coalesced rows from L2; a row column is not coalesced) it is
    windowed: phi's plane stays, and each warp copies ROW_WINDOW levels of
    its chunk for the tile's columns at a time into ROW_WINDOW_SLOTS[r0]
    slots of its own (32 bytes a column: one sector), pass by pass, and
    writes a window's outputs back the same way; one block an SM up to
    400 levels. Raises on shapes the kernel refuses."""
    plan = dataclasses.replace(caar_plan(ncol, nlev), stash=True, row=True,
                               r0=bool(r0))
    if plan.smem > SMEM_MAX:
        plan = dataclasses.replace(plan, stash=False)
    return plan


def caar_ring_plan(ncol: int, nlev: int, tile: int = RING_TILE) -> CaarPlan:
    """The ring kernel's producer plan: ``caar_plan``'s chunks on the ring's
    tiles of ``tile`` columns (RING_TILE, the chunked kernel's own 32), with
    the stash wherever it leaves at least two blocks an SM, so at RING_TILE
    it is ``caar_plan`` itself and the ring's CAAR part sums every column as
    the chunked kernel does. Raises where the kernel refuses: a column count
    that is not a positive multiple of the tile (a tile's rows of s1 are
    whole 128-byte lines, which the kernel discards from L2 once read)."""
    if ncol < tile or ncol % tile:
        raise ValueError(f"caar_ring: ncol={ncol} is not a positive multiple"
                         f" of the ring's {tile}-column tile")
    plan = dataclasses.replace(caar_plan(ncol, nlev), tile=tile)
    if plan.stash and (plan.blocks_per_sm < 2 or plan.smem > SMEM_MAX):
        plan = dataclasses.replace(plan, stash=False)
    if plan.smem > SMEM_MAX:
        raise ValueError(f"caar_ring: nlev={nlev} needs {plan.smem} bytes "
                         f"of shared memory a block, over {SMEM_MAX}")
    return plan


def _physics_plain(scal, meta, dvv, u, v, t, dp, um1, vm1, tm1, dpm1,
                   qdp, pecnd, moist, hyb=None):
    """``_caar_physics`` on [k, E16] tensors: returns (u1, v1, t1, dp1, phi,
    vdp1, vdp2, omega_p, eta_hi). With ``hyb`` ([k, 2]: hybi(k), hybi(k+1))
    it is the rsplit=0 step of ``_caar_kernel_t`` (caar_pallas_t.py:265-290)
    and eta_hi the flux at interfaces 1..k; else eta_hi is None."""
    full_precision_matmuls()
    # the storage operands upcast exactly (bf16 storage; a no-op in f32)
    um1, vm1, tm1, dpm1, qdp, pecnd = (
        x.to(u.dtype) for x in (um1, vm1, tm1, dpm1, qdp, pecnd))
    c = CONSTANTS
    k, e16 = u.shape
    ne = e16 // NPSQ
    dt2, h = scal[0, 0], scal[0, 2]
    rr = c.rrearth

    def row(name):
        return meta[_MC[name]]                       # [E16], broadcast on k

    def dx(s):
        return torch.einsum("il,keij->kelj", dvv,
                            s.reshape(k, ne, 4, 4)).reshape(k, e16)

    def dy(s):
        return torch.einsum("keji,il->kejl", s.reshape(k, ne, 4, 4),
                            dvv).reshape(k, e16)

    dinv00, dinv01 = row("dinv00"), row("dinv01")
    dinv10, dinv11 = row("dinv10"), row("dinv11")
    metdet, rmetdet = row("metdet"), row("rmetdet")

    def grad(s):
        v1, v2 = dx(s) * rr, dy(s) * rr
        return dinv00 * v1 + dinv10 * v2, dinv01 * v1 + dinv11 * v2

    def div(a, b):
        gv1 = metdet * (dinv00 * a + dinv01 * b)
        gv2 = metdet * (dinv10 * a + dinv11 * b)
        return (dx(gv1) + dy(gv2)) * (rmetdet * rr)

    zero = torch.zeros_like(dp[:1])
    p = h + torch.cumsum(dp, 0) - 0.5 * dp
    gp1, gp2 = grad(p)
    vgrad_p = u * gp1 + v * gp2
    vdp1, vdp2 = u * dp, v * dp
    divdp = div(vdp1, vdp2)
    vco1 = row("d00") * u + row("d10") * v
    vco2 = row("d01") * u + row("d11") * v
    vort = (dx(vco2) - dy(vco1)) * (rmetdet * rr)
    t_v = t * (1.0 + c.rgas_over_rvap_m1 * (qdp / dp)) if moist else t
    q = c.Rgas * t_v * (dp / p)
    rev_strict = torch.cat([torch.flip(torch.cumsum(torch.flip(q, (0,)), 0),
                                       (0,))[1:], zero])
    phi = row("phis") + rev_strict + 0.5 * q
    cum_strict = torch.cat([zero, torch.cumsum(divdp, 0)[:-1]])
    omega_p = (vgrad_p - cum_strict - 0.5 * divdp) / p
    eta_hi = None
    if hyb is None:
        t_vadv = u_vadv = v_vadv = 0.0
        dptens = divdp
    else:
        # interface mass flux: the boundary zeros by mask, not computed
        cum_inc = cum_strict + divdp
        sdot = cum_inc[k - 1:k]                      # column total [1, E16]
        lev = torch.arange(k, device=u.device)[:, None]
        eta_lo = torch.where(lev > 0, hyb[:, 0:1] * sdot - cum_strict, 0.0)
        eta_hi = torch.where(lev < k - 1, hyb[:, 1:2] * sdot - cum_inc, 0.0)
        rpdel = 1.0 / dp
        facp = 0.5 * rpdel * eta_hi
        facm = 0.5 * rpdel * eta_lo

        def vadv(x):
            dxp = x[1:] - x[:-1]                     # x(k+1) - x(k)
            return facp * torch.cat([dxp, zero]) + facm * torch.cat([zero, dxp])

        t_vadv, u_vadv, v_vadv = vadv(t), vadv(u), vadv(v)
        dptens = divdp + (eta_hi - eta_lo)
    ephi = 0.5 * (u * u + v * v) + phi + pecnd
    gt1, gt2 = grad(t)
    ge1, ge2 = grad(ephi)
    gpterm = c.Rgas * (t_v / p)
    fcor_vort = row("fcor") + vort
    vtens1 = -u_vadv + v * fcor_vort - ge1 - gpterm * gp1
    vtens2 = -v_vadv - (u * fcor_vort) - ge2 - gpterm * gp2
    ttens = -t_vadv - (u * gt1 + v * gt2) + c.kappa * t_v * omega_p
    sph = row("spheremp")
    return (sph * (um1 + dt2 * vtens1), sph * (vm1 + dt2 * vtens2),
            sph * (tm1 + dt2 * ttens), sph * (dpm1 - dt2 * dptens),
            phi, vdp1, vdp2, omega_p, eta_hi)


def _slab_plain(s1: torch.Tensor, fix) -> torch.Tensor:
    """The fix-lane slab of a [4*nlev, E16] state: s1[:, lanes].T."""
    return s1[:, fix.read_lanes.long()].T.contiguous()


def caar_t4_plain(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                  moist: bool = True, fix=None, single: bool = False,
                  emit_phi: bool = True):
    """Plain PyTorch CAAR step on stacked [4*nlev, E16] states. Pure:
    returns new (s1, phi, vn0u', vn0v', omg') and modifies nothing; with
    ``fix`` also the fix-lane slab of s1. ``single`` takes s0 as the base
    state too (``sm1`` ignored); without ``emit_phi`` (a stage only) phi is
    None."""
    k = qdp.shape[0]
    if not single and not emit_phi:
        raise ValueError("caar: emit_phi=False needs single=True")
    base = s0 if single else sm1
    u1, v1, t1, dp1, phi, vdp1, vdp2, omega_p, _ = _physics_plain(
        scal, meta, dvv, *s0.split(k), *base.split(k), qdp, pecnd, moist)
    eta = scal[0, 1]
    s1 = torch.cat([u1, v1, t1, dp1])
    out = (s1, phi if emit_phi else None, vn0u + eta * vdp1,
           vn0v + eta * vdp2, omg + eta * omega_p)
    return out if fix is None else (*out, _slab_plain(s1, fix))


def _check(scal, meta, dvv, fields, nlev, hyb=None, row=False, states=(),
           aux=(), nm1=None):
    """Validate the operands of one CAAR step on the t ([nlev, E16] fields,
    [16, E16] meta, [nlev, 2] hyb) or the row ([E16, nlev], [E16, 16],
    [2, nlev]) layout. ``states`` are states of four fields (u, v, t, dp),
    each a 4-tuple of fields or, on the t layout, one stacked [4*nlev, E16]
    tensor, the n0 state first: its dtype is the step's, which every
    operand holds but the storage operands. ``fields`` are single fields
    (the accumulators, phi, etaacc); ``aux`` is (qdp, pecnd) and ``nm1``
    the base state (None in the stage mode), each bf16 or the step's dtype
    as one of the STORAGE contracts admits (``_storage``). Returns the
    device. One pass of cheap tests; the message is made only where one
    fails."""
    first = states[0]
    ref = first if isinstance(first, torch.Tensor) else first[0]
    dev, dtype = ref.device, ref.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"caar: needs float fields, got {dtype}")
    if dev.type == "cuda" and dtype != torch.float32:
        raise TypeError("caar: the CUDA kernel takes float32 only")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"caar: unsupported device {dev}")
    e16 = ref.shape[0 if row else -1]
    if e16 % NPSQ:
        raise ValueError(f"caar: E16={e16} is not a multiple of {NPSQ}")
    one = (e16, nlev) if row else (nlev, e16)
    exact, stored = (dtype,), (dtype, _BF16)
    want = [(meta, (e16, len(META_COLS)) if row else (len(META_COLS), e16),
             "meta", exact), (dvv, (4, 4), "dvv", exact),
            (scal, (1, 4), "scal", exact)]
    if hyb is not None:
        want.append((hyb, (2, nlev) if row else (nlev, 2), "hyb", exact))

    def add(st, name, names, dtypes):
        if isinstance(st, torch.Tensor):
            want.append((st, (4 * nlev, e16), name, dtypes))
        else:
            want.extend((x, one, n, dtypes) for x, n in zip(st, names))

    for st in states:
        add(st, "a stacked state", ("a state's field",) * 4, exact)
    if nm1 is not None:
        add(nm1, "sm1", _NM1_NAMES, stored)
    want += [(x, one, n, stored) for x, n in zip(aux, ("qdp", "pecnd"))]
    want += [(x, one, "a field", exact) for x in fields]
    for x, shape, name, dtypes in want:
        if x.shape != shape or x.dtype not in dtypes or x.device != dev or \
                not x.is_contiguous():
            if tuple(x.shape) != shape:
                raise ValueError(f"caar: {name} has shape {tuple(x.shape)},"
                                 f" expected {shape}")
            if x.device != dev or x.dtype not in dtypes:
                raise ValueError(
                    f"caar: {name} is {x.dtype} on {x.device}, expected "
                    f"{' or '.join(map(str, dtypes))} on {dev}")
            raise ValueError(f"caar: {name} must be contiguous")
    _storage(aux, nm1)
    return dev


_NM1_NAMES = ("um1", "vm1", "tm1", "dpm1")


def _storage(aux, nm1) -> int:
    """The kernel's storage code (csrc/caar.cu kSt) of dtype-checked storage
    operands: ``aux`` = (qdp, pecnd), ``nm1`` the base state (stacked, a
    4-tuple, or None in the stage mode). The pair form takes the STORAGE
    contracts: qdp and pecnd bf16 together, the four nm1 fields bf16
    together and only with them. The stage mode takes what the JAX
    package's full step hands its stage kernel under ``bench --prim
    --storage``: bf16 qdp and pecnd (1), or an f32 qdp beside a bf16 pecnd
    (``STAGE_PECND``, 3). Raises, naming the field, on any other mix."""
    qdp, pecnd = aux
    qbf, pbf = qdp.dtype == _BF16, pecnd.dtype == _BF16
    if nm1 is None:
        if qbf and not pbf:
            raise ValueError(f"caar: qdp is {qdp.dtype} but pecnd is "
                             f"{pecnd.dtype}: the stage mode (sm1=None) "
                             "takes a bf16 qdp beside a bf16 pecnd only")
        return 1 if qbf else STAGE_PECND if pbf else 0
    if qbf != pbf:
        raise ValueError(f"caar: qdp is {qdp.dtype} but pecnd is "
                         f"{pecnd.dtype}: bf16 storage stores qdp and pecnd "
                         "together (bf16_aux)")
    code = int(qbf)
    base = (nm1,) * 4 if isinstance(nm1, torch.Tensor) else tuple(nm1)
    bf = [x.dtype == _BF16 for x in base]
    if any(bf) != all(bf):
        lone = _NM1_NAMES[bf.index(True)]
        other = _NM1_NAMES[bf.index(False)]
        raise ValueError(f"caar: {lone} is bfloat16 but {other} is "
                         f"{base[bf.index(False)].dtype}: bf16_ro stores the "
                         "four nm1 fields together")
    if bf[0] and not code:
        raise ValueError(f"caar: {_NM1_NAMES[0]} and the other nm1 fields "
                         "are bfloat16 but qdp and pecnd are not: bf16_ro "
                         "stores qdp and pecnd in bf16 too")
    return 2 if bf[0] else code


def _new_slab(fix, ref: torch.Tensor, nlev: int):
    """The slab buffer [nfix, 4*nlev] for ``fix``, checked against ``ref``."""
    if fix is None:
        return None
    rank, lanes = fix.fix_rank, fix.read_lanes
    if rank.device != ref.device or rank.dtype != torch.int32 \
            or tuple(rank.shape) != (ref.shape[1],):
        raise ValueError(f"caar: fix_rank must be int32 [{ref.shape[1]}] on "
                         f"{ref.device}, got {rank.dtype} "
                         f"{tuple(rank.shape)} on {rank.device}")
    return torch.empty(lanes.shape[0], 4 * nlev, dtype=ref.dtype,
                       device=ref.device)


def _blocks(state, nlev: int):
    """The four [nlev, E16] fields of a state: a 4-tuple, or views of a
    stacked [4*nlev, E16] tensor."""
    return state.split(nlev) if isinstance(state, torch.Tensor) else state


def _addresses(state, nlev: int) -> list:
    """The device addresses of a state's four fields."""
    if isinstance(state, torch.Tensor):
        base = state.data_ptr()
        step = nlev * state.shape[1] * state.element_size()
        return [base + i * step for i in range(4)]
    return [x.data_ptr() for x in state]


def _caar_step(scal, meta, dvv, s0, sm1, qdp, pecnd, acc, out, phi, moist,
               fix=None, slab=None, hyb=None, etaacc=None, row=False) -> bool:
    """One step, the one path of every entry: s0/sm1/out are states (a
    4-tuple (u, v, t, dp) of [nlev, E16] fields, with ``row`` [E16, nlev]
    fields and the row layout's meta and hyb, or on the t layout one stacked
    [4*nlev, E16] tensor), acc the 3 accumulators (updated in place), phi
    the output buffer; with ``fix``, ``slab`` [nfix, 4*nlev] receives the
    fix-lane rows of out. ``sm1=None`` is the Runge-Kutta stage (base state
    = s0, not fetched again); ``phi=None`` stores no geopotential. With
    ``hyb`` and ``etaacc`` it is the rsplit=0 step, etaacc updated in place.
    qdp, pecnd and sm1 may be bf16 (the STORAGE contracts). Returns True
    where it launched the kernel (CUDA tensors), False where the plain
    version ran (CPU tensors)."""
    nlev = qdp.shape[1 if row else 0]
    single = sm1 is None
    r0 = etaacc is not None
    dev = _check(scal, meta, dvv,
                 (*acc, *(() if phi is None else (phi,)),
                  *(() if etaacc is None else (etaacc,))), nlev, hyb, row,
                 (s0, out), (qdp, pecnd), sm1)
    if dev.type == "cpu":
        tr = (lambda x: x.T) if row else (lambda x: x)
        s0, out = _blocks(s0, nlev), _blocks(out, nlev)
        base = s0 if single else _blocks(sm1, nlev)
        u1, v1, t1, dp1, ph, vdp1, vdp2, omega_p, eta_hi = _physics_plain(
            scal, tr(meta), dvv, *map(tr, s0), *map(tr, base), tr(qdp),
            tr(pecnd), moist, None if hyb is None else tr(hyb))
        for o, r in zip(out, (u1, v1, t1, dp1)):
            o.copy_(tr(r))
        if phi is not None:
            phi.copy_(tr(ph))
        eta = scal[0, 1]
        for a, r in zip(acc, (vdp1, vdp2, omega_p)):
            a.add_(eta * tr(r))
        if r0:
            etaacc.add_(eta * tr(eta_hi))
        if slab is not None:
            slab.copy_(_slab_plain(torch.cat(out), fix))
        return False
    # the kernels' refusals are their plans'
    p = (caar_row_plan(qdp.shape[0], nlev, r0) if row
         else caar_plan(qdp.shape[1], nlev, r0))
    plan = (p.chunks, p.levels, int(p.stash), p.blocks_per_sm)
    storage = _storage((qdp, pecnd), sm1)
    if storage and row and (qdp.data_ptr() % 4 or pecnd.data_ptr() % 4):
        raise ValueError("caar: bf16 qdp and pecnd on the row layout must "
                         "be 4-byte aligned (the kernel loads pairs)")
    ptr = lambda x: 0 if x is None else x.data_ptr()
    c = CONSTANTS
    # hybi(k) and hybi(k+1) as two strided vectors of hyb, whichever layout
    hs = 1 if row else 2
    err = _build.library("caar").caar_launch(
        ptr(scal), ptr(meta), ptr(dvv), *_addresses(s0, nlev),
        *((0,) * 4 if single else _addresses(sm1, nlev)),
        ptr(qdp), ptr(pecnd), *map(ptr, acc), *_addresses(out, nlev),
        ptr(phi), ptr(None if fix is None else fix.fix_rank), ptr(slab),
        ptr(hyb), 0 if hyb is None else hyb.data_ptr() + (
            nlev if row else 1) * hyb.element_size(), ptr(etaacc),
        nlev, qdp.shape[0 if row else 1], qdp.stride(0), int(bool(moist)),
        4 * nlev, hs, int(row), *plan, storage, c.Rgas, c.kappa,
        c.rgas_over_rvap_m1,
        c.rrearth, torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check_launch("caar", err)
    return True


def _count_t4(slab, single, pecnd):
    caar_t4_cuda.launches += 1
    if slab is not None:
        caar_t4_cuda.slab_launches += 1
    if single:
        caar_t4_cuda.single_launches += 1
    caar_t4_cuda.storage_launches += pecnd.dtype == _BF16


@launch_span
def caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, vn0u, vn0v, omg, dvv,
                 moist: bool = True, fix=None, single: bool = False,
                 emit_phi: bool = True):
    """Stacked-state CAAR step (counterpart of ``caar_pallas_packed_t4_lg``,
    ``caar_pallas_packed_t4`` and, with ``fix``, their slab-emitting forms
    ``caar_pallas_packed_t4_lg(sf=, cq=)`` and ``caar_pallas_packed_t4_ext``;
    with ``single=True`` of ``caar_pallas_packed_t4_rk`` and
    ``caar_pallas_packed_t4_lg(single=True)``).
    scal [1,4] = (dt2, eta_ave_w, hyai0*ps0, 0); meta [16, E16]; s0, sm1
    [4*nlev, E16] (u/v/t/dp row blocks); qdp, pecnd, vn0u, vn0v, omg
    [nlev, E16]; dvv [4, 4]. The accumulators are updated IN PLACE.
    ``single`` is the Runge-Kutta stage: s1 = spheremp*(s0 + dt2*tendency),
    ``sm1`` is ignored (pass None) and never fetched. Without ``emit_phi``
    (a stage only: the pair form always stores phi) the geopotential is not
    stored and None stands in its place. Returns (s1, phi, vn0u, vn0v,
    omg), and the fix-lane slab last with ``fix``."""
    k = qdp.shape[0]
    if not single and sm1 is None:
        raise ValueError("caar: sm1 is required unless single=True")
    if not single and not emit_phi:
        raise ValueError("caar: emit_phi=False needs single=True")
    if s0.shape[0] != 4 * k or (not single and sm1.shape[0] != 4 * k):
        raise ValueError(f"caar: s0/sm1 need {4 * k} rows, got {s0.shape[0]}"
                         + ("" if single else f"/{sm1.shape[0]}"))
    s1 = torch.empty_like(s0)
    phi = s0.new_empty(qdp.shape) if emit_phi else None
    slab = _new_slab(fix, s0, k)
    if _caar_step(scal, meta, dvv, s0, None if single else sm1, qdp, pecnd,
                  (vn0u, vn0v, omg), s1, phi, moist, fix, slab):
        _count_t4(slab, single, pecnd)
    out = (s1, phi, vn0u, vn0v, omg)
    return out if fix is None else (*out, slab)


caar_t4_cuda.launches = 0
caar_t4_cuda.slab_launches = 0     # the launches among them with a slab
caar_t4_cuda.single_launches = 0   # the launches among them in stage mode
caar_t4_cuda.storage_launches = 0  # those in a bf16 storage mode (with
                                   # caar_packed_t's)


def caar_packed_t(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1,
                  qdp, pecnd, vn0u, vn0v, omg, dvv, moist: bool = True,
                  fix=None):
    """Unstacked CAAR step (counterpart of ``caar_pallas_packed_t``): one
    [nlev, E16] buffer per field, the same kernel. Accumulators in place.
    Returns (u1, v1, t1, dp1, phi, vn0u, vn0v, omg), and with ``fix`` the
    fix-lane slab [nfix, 4*nlev] (u/v/t/dp column blocks) last."""
    out = tuple(torch.empty_like(x) for x in (u0, v0, t0, dp0))
    phi = torch.empty_like(u0)
    slab = _new_slab(fix, u0, qdp.shape[0])
    if _caar_step(scal, meta, dvv, (u0, v0, t0, dp0), (um1, vm1, tm1, dpm1),
                  qdp, pecnd, (vn0u, vn0v, omg), out, phi, moist, fix, slab):
        _count_t4(slab, False, pecnd)
    res = (*out, phi, vn0u, vn0v, omg)
    return res if fix is None else (*res, slab)


def caar_packed_rsplit0_t_plain(scal, hyb, meta, u0, v0, t0, dp0, um1, vm1,
                                tm1, dpm1, qdp, pecnd, vn0u, vn0v, omg, etaacc,
                                dvv, moist: bool = True):
    """Plain PyTorch ``caar_packed_rsplit0_t``. Pure: returns new (u1, v1,
    t1, dp1, phi, vn0u', vn0v', omg', etaacc') and modifies nothing."""
    u1, v1, t1, dp1, phi, vdp1, vdp2, omega_p, eta_hi = _physics_plain(
        scal, meta, dvv, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp, pecnd,
        moist, hyb)
    eta = scal[0, 1]
    return (u1, v1, t1, dp1, phi, vn0u + eta * vdp1, vn0v + eta * vdp2,
            omg + eta * omega_p, etaacc + eta * eta_hi)


def caar_packed_rsplit0_t(scal, hyb, meta, u0, v0, t0, dp0, um1, vm1, tm1,
                          dpm1, qdp, pecnd, vn0u, vn0v, omg, etaacc, dvv,
                          moist: bool = True):
    """The rsplit=0 (full eta-coordinate) step on unstacked [nlev, E16]
    buffers (counterpart of ``caar_pallas_packed_rsplit0_t``): the CAAR step
    plus the interface mass flux, the vertical advection of u, v and T and
    the dp3d interface stencil. ``hyb`` [nlev, 2] holds hybi(k) in column 0
    and hybi(k+1) in column 1; ``etaacc`` is the eta_dot_dpdn accumulator at
    interfaces 1..nlev. The four accumulators are updated IN PLACE. Returns
    (u1, v1, t1, dp1, phi, vn0u, vn0v, omg, etaacc)."""
    out = tuple(torch.empty_like(x) for x in (u0, v0, t0, dp0))
    phi = torch.empty_like(u0)
    if _caar_step(scal, meta, dvv, (u0, v0, t0, dp0), (um1, vm1, tm1, dpm1),
                  qdp, pecnd, (vn0u, vn0v, omg), out, phi, moist, hyb=hyb,
                  etaacc=etaacc):
        caar_packed_rsplit0_t.launches += 1
        caar_packed_rsplit0_t.storage_launches += qdp.dtype == _BF16
    return (*out, phi, vn0u, vn0v, omg, etaacc)


caar_packed_rsplit0_t.launches = 0
caar_packed_rsplit0_t.storage_launches = 0


def _storage_casts(dtype, storage: str, name: str):
    """The casts of ``pack_problem_t``'s storage contract: (f, aux, ro), each
    a field to the packed dtype, aux for qdp and pecnd, ro for the nm1
    fields; a bf16 field is cast from the state's own dtype, as the JAX
    package's ``jnp.asarray(x, jnp.bfloat16)``. Raises on a storage name
    the JAX package refuses."""
    if storage not in STORAGE:
        raise ValueError(f"{name}: storage={storage!r}, expected one of "
                         f"{tuple(STORAGE)}")
    f = lambda x: x.to(dtype)
    bf = lambda x: x.to(_BF16)
    return (f, bf if storage != "f32" else f,
            bf if storage == "bf16_ro" else f)


def pack_problem_t(state: State, derived: Derived, geom: Geometry,
                   hv: HybridVCoord, cfg: Config, dtype=torch.float32,
                   storage: str = "f32"):
    """Pack into the kernel layout on the state's device (on the CPU any
    float dtype). ``storage`` is the JAX package's mixed-precision contract
    (``STORAGE``): "f32", "bf16_aux" (qdp and pecnd in bf16) or "bf16_ro"
    (also the four nm1 fields); every other operand is ``dtype``."""
    f, aux, ro = _storage_casts(dtype, storage, "pack_problem_t")
    n0, nm1, qn0 = cfg.n0, cfg.nm1, cfg.qn0
    p = lambda cast, x: pack_field_t(cast(x))
    return dict(
        dvv=geom.dvv.to(dtype).contiguous(),
        meta=pack_meta_t(geom, state.phis, dtype),
        u0=p(f, state.u[n0]), v0=p(f, state.v[n0]),
        t0=p(f, state.t[n0]), dp0=p(f, state.dp3d[n0]),
        um1=p(ro, state.u[nm1]), vm1=p(ro, state.v[nm1]),
        tm1=p(ro, state.t[nm1]), dpm1=p(ro, state.dp3d[nm1]),
        qdp=p(aux, state.qdp[qn0, :, 0]),
        pecnd=p(aux, derived.pecnd),
        vn0u=p(f, derived.vn0_u), vn0v=p(f, derived.vn0_v),
        omg=p(f, derived.omega_p),
    )


def storage_cast(p: dict, storage: str) -> dict:
    """A packed f32 problem dict put in ``storage``'s contract in place (the
    JAX bench's post-init cast of its direct-packed problem, bench.py:
    294-302): qdp and pecnd to bf16, with "bf16_ro" the nm1 fields too.
    Returns ``p``."""
    _storage_casts(torch.float32, storage, "storage_cast")
    names = {"f32": (), "bf16_aux": ("qdp", "pecnd"),
             "bf16_ro": ("qdp", "pecnd", *_NM1_NAMES)}[storage]
    for name in names:
        p[name] = p[name].to(_BF16)
    return p


def random_packed_problem_t(cfg: Config, seed: int = 1,
                            geom: Geometry | None = None, device="cuda",
                            storage: str = "f32"):
    """The packed f32 problem dict of ``pack_problem_t`` drawn directly on
    the device at [nlev, E16] from a ``torch.Generator`` seeded with
    ``seed``: the unpacked [tl, nelem, nlev, 4, 4] state is never made, which
    is what lets the ne120-class grid (86,400 elements) build on one card.
    The state's distributions are ``random_state``'s (positive dp), qdp and
    pecnd U(0, 1), zero accumulators. With ``geom`` (a real cubed sphere's
    geometry, as an assembled bench needs) meta is its packed metric rows
    (phis 0) and dvv its operator; without, the metric rows are O(1)
    random with rmetdet = 1/metdet and zero pads, and dvv ``dvv_matrix``.
    ``storage`` casts the drawn f32 fields into its contract after the draw
    (``storage_cast``), as the JAX bench does."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    e16, k = cfg.nelem * NPSQ, cfg.nlev
    u = lambda lo, hi, shape=(k, e16): uniform(gen, shape, lo, hi)
    if geom is not None:
        geom = geom.to(dev)
        meta = pack_meta_t(geom, torch.zeros(cfg.nelem, 4, 4, device=dev),
                           torch.float32)
        dvv = geom.dvv.to(torch.float32).contiguous()
    else:
        meta = u(0.5, 1.5, (len(META_COLS), e16))
        meta[_MC["rmetdet"]] = 1.0 / meta[_MC["metdet"]]
        meta[_MC["pad1"]:] = 0.0
        dvv = torch.from_numpy(dvv_matrix()).to(dev, torch.float32)
    p = dict(dvv=dvv, meta=meta)
    for name, lo, hi in (("u0", -1, 1), ("v0", -1, 1), ("t0", 250, 300),
                         ("dp0", 10, 20), ("um1", -1, 1), ("vm1", -1, 1),
                         ("tm1", 250, 300), ("dpm1", 10, 20), ("qdp", 0, 1),
                         ("pecnd", 0, 1)):
        p[name] = u(lo, hi)
    for name in ("vn0u", "vn0v", "omg"):
        p[name] = torch.zeros(k, e16, dtype=torch.float32, device=dev)
    return storage_cast(p, storage)


def _scalars(dt2, eta_ave_w, hv: HybridVCoord, dtype, device):
    """The kernel's [1, 4] scalar operand: (dt2, eta_ave_w, hyai0*ps0, 0)."""
    return torch.tensor(
        [[float(dt2), float(eta_ave_w), float(hv.hyai[0]) * hv.ps0, 0.0]],
        dtype=dtype, device=device)


def _on(device, *objs):
    dev = resolve_device(device)
    return dev, [o.to(dev) for o in objs]


def caar_t(state: State, derived: Derived, geom: Geometry, hv: HybridVCoord,
           cfg: Config, dt2, eta_ave_w, moist: bool = True, device="cuda",
           storage: str = "f32"):
    """Full-state wrapper with the contract of ``caar_array`` on the packed
    layout (counterpart of ``caar_pallas_t``): pack (in ``storage``'s
    contract, ``pack_problem_t``), one kernel step, unpack.
    ``cfg.rsplit`` = 0 runs ``caar_packed_rsplit0_t`` and advances
    eta_dot_dpdn at interfaces 1..nlev (interface 0 keeps the old value);
    rsplit>0 ``caar_packed_t``, eta_dot_dpdn unchanged. Returns (new_state,
    new_derived) on ``device``, in the state's dtype."""
    step = caar_packed_t if cfg.rsplit > 0 else caar_packed_rsplit0_t
    return full_step(step, T_PACKING, state, derived, geom, hv, cfg, dt2,
                     eta_ave_w, moist, device, storage)


@dataclasses.dataclass(frozen=True)
class Packing:
    """How one packed layout packs a problem: ``problem`` (the operand dict
    of ``pack_problem_t``'s contract, its ``storage=`` included), ``field``
    and ``unfield`` (one field), ``hyb`` (hybi to the layout's [nlev, 2] or
    [2, nlev])."""

    problem: object
    field: object
    unfield: object
    hyb: object


def _hyb_t(hybi, nlev):
    return torch.stack([hybi[:nlev], hybi[1:nlev + 1]], dim=1).contiguous()


T_PACKING = Packing(problem=pack_problem_t, field=pack_field_t,
                   unfield=unpack_field_t, hyb=_hyb_t)


def full_step(step, packing: Packing, state: State, derived: Derived,
              geom: Geometry, hv: HybridVCoord, cfg: Config, dt2, eta_ave_w,
              moist: bool = True, device="cuda", storage: str = "f32"):
    """One full-state step through the packed ``step`` (a pair step, or with
    ``cfg.rsplit`` = 0 an rsplit=0 step) on ``packing``'s layout: pack (in
    ``storage``'s contract), step, unpack into time level np1 and the
    derived state. Any step of the wrapper's call form serves, its plain
    version included."""
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = packing.problem(state, derived, geom, hv, cfg, dtype, storage)
    scal = _scalars(dt2, eta_ave_w, hv, dtype, dev)
    args = (p["u0"], p["v0"], p["t0"], p["dp0"], p["um1"], p["vm1"],
            p["tm1"], p["dpm1"], p["qdp"], p["pecnd"], p["vn0u"], p["vn0v"],
            p["omg"])
    ne, np1 = cfg.nelem, cfg.np1
    if cfg.rsplit > 0:
        u1, v1, t1, dp1, phi, vn0u, vn0v, omg = step(
            scal, p["meta"], *args, p["dvv"], moist=moist)
        eta_dot = derived.eta_dot_dpdn
    else:
        etaacc = packing.field(derived.eta_dot_dpdn[:, 1:].to(dtype))
        (u1, v1, t1, dp1, phi, vn0u, vn0v, omg, eta_new) = step(
            scal, packing.hyb(hv.hybi.to(dtype), cfg.nlev), p["meta"], *args,
            etaacc, p["dvv"], moist=moist)
        eta_dot = torch.cat([derived.eta_dot_dpdn[:, :1].to(dtype),
                             packing.unfield(eta_new, ne)], dim=1)
    un = lambda x: packing.unfield(x, ne)

    def put(x, packed):
        out = x.clone()
        out[np1] = un(packed)
        return out

    new_state = dataclasses.replace(
        state, u=put(state.u, u1), v=put(state.v, v1), t=put(state.t, t1),
        dp3d=put(state.dp3d, dp1))
    new_derived = dataclasses.replace(
        derived, vn0_u=un(vn0u), vn0_v=un(vn0v), phi=un(phi),
        omega_p=un(omg), eta_dot_dpdn=eta_dot)
    return new_state, new_derived


_LF_NAMES = ("u", "v", "t", "dp3d")


def run_leapfrog_t(state: State, derived: Derived, geom: Geometry,
                   hv: HybridVCoord, cfg: Config, nsteps: int,
                   moist: bool = True, device="cuda"):
    """Production leapfrog loop on the packed layout (counterpart of
    ``run_leapfrog_pallas_t``): pack once, one ``caar_t4_cuda`` step per time
    step with time-level rotation, unpack once. dt2 = 2*dt and
    eta_ave_w = 1/nsteps. Returns (state, derived, cfg) with cfg carrying
    the rotated time levels."""
    return _leapfrog_loop(caar_t4_cuda, state, derived, geom, hv, cfg,
                          nsteps, moist, device)


def _leapfrog_loop(step, state, derived, geom, hv, cfg, nsteps, moist,
                   device):
    """The loop of ``run_leapfrog_t`` with the step function as a parameter,
    so a check on the card can run the same loop on ``caar_t4_plain``."""
    from ..timeloop.driver import rotated

    if cfg.rsplit <= 0:
        raise NotImplementedError(
            "the packed leapfrog loop supports only rsplit > 0")
    dev, (state, derived, geom, hv) = _on(device, state, derived, geom, hv)
    dtype = state.u.dtype
    p = pack_problem_t(state, derived, geom, hv, cfg, dtype)
    scal = _scalars(2.0 * cfg.dt, 1.0 / max(nsteps, 1), hv, dtype, dev)
    bufs = [torch.cat([pack_field_t(getattr(state, n)[tl].to(dtype))
                       for n in _LF_NAMES]) for tl in range(3)]
    acc = (p["vn0u"], p["vn0v"], p["omg"])
    phi = None
    c = cfg
    for _ in range(nsteps):
        s1, phi, *acc = step(scal, p["meta"], bufs[c.n0], bufs[c.nm1],
                             p["qdp"], p["pecnd"], *acc, p["dvv"],
                             moist=moist)
        bufs[c.np1] = s1
        c = rotated(c)

    ne, k = cfg.nelem, cfg.nlev
    un = lambda x: unpack_field_t(x, ne)
    new_state = dataclasses.replace(state, **{
        n: torch.stack([un(bufs[tl][i * k:(i + 1) * k]) for tl in range(3)])
        for i, n in enumerate(_LF_NAMES)})
    new_derived = dataclasses.replace(
        derived, vn0_u=un(acc[0]), vn0_v=un(acc[1]), omega_p=un(acc[2]),
        phi=derived.phi.clone() if phi is None else un(phi))
    return new_state, new_derived, c
