"""The schedules and layouts that the ring kernels and the banded sweep
kernel (``csrc/caar.cu``, ``csrc/tracer.cu``, ``csrc/ring.cuh``,
``csrc/dss.cu``) rely on, held on the CPU where the kernels cannot run.

  * The CAAR ring's schedule, modelled from ``ring_plan`` (the plan the
    wrapper launches): blocks start in ticket order at any residency, the
    block of ticket t produces tile t, flags it, waits on ``waits(t)``,
    sweeps tile t - halo - lag and counts itself a reader of the tiles it
    waited on; the count that reaches ``readers(u)`` discards tile u's s1
    lines. For ne 2..32 and nlev 26, 72 and 150, at the plan's lag and
    none, at the card's residency and at 1, 2 and 5 resident blocks, with
    random durations: every wait is on a tile of a lower or equal ticket,
    every block finishes, every tile is discarded once and never before the
    last sweep that reads it (the lanes each sweep reads, from the sweep's
    partner offsets) is done.
  * The plan refuses exactly the shapes the launch refuses: the launch's
    conditions restated from ``caar_ring_launch`` with its constants read
    from the source.
  * The tracer ring's schedule, modelled from ``tracer_ring_plan``: items
    (row block, tile) row-block-major, a row block some level chunks of
    some tracers, the block of ticket t < items producing item t, every
    block sweeping the item halo + lag tickets behind its own after waiting
    on its row block's tiles, and the last reader of a tile discarding it;
    for ne 2..32, nlev 26 at qsize 35 (16 row blocks of a chunk and 9 or 8
    tracers), 72 and 150 at qsize 1 (row blocks of three chunks), the
    plan's lag and none, 1, 2 and 5 resident blocks and the card's
    residency, with the same checks; the plan refusing exactly what
    ``tracer_ring_launch`` refuses (constants read from
    ``csrc/tracer.cu``); and both wrappers' CUDA branches, with the launch
    stubbed, taking a new launch state each call and passing no epoch.
  * The banded sweep's layout facts (``band_layout``) on every
    decomposition the banded tests and the card's phase 18 use, each group
    of 4 lanes in one chunk and every x_ext row 16-byte aligned; the
    kernel's group form (``swept4_banded``: partner offsets, sums in
    ``swept4``'s order) emulated in numpy f32 bit for bit the plain banded
    sweep; the wrapper's CUDA branch refusing a bad layout or a misaligned
    field before it touches a card.
"""
import collections
import dataclasses
import heapq
import importlib
import os
import re
import types

import numpy as np
import pytest
import torch

from tinman_sandbox_tpu_torch.dist.banded_t4 import _banded_tables
from tinman_sandbox_tpu_torch.dist.dss import mul_2f
from tinman_sandbox_tpu_torch.kernels import dss
from tinman_sandbox_tpu_torch.kernels.dss import (
    _banded_plain, band_layout, band_masks, band_tables,
    dss_sweep_banded_cuda, dss_sweep_banded_nomerge_cuda)
from tinman_sandbox_tpu_torch import bench
from tinman_sandbox_tpu_torch.kernels import _build, ring_fused
from tinman_sandbox_tpu_torch.kernels.dss import fix_tables
from tinman_sandbox_tpu_torch.kernels.ring_fused import (
    RING_LAG, TRACER_RING_LAG, TRACER_RING_LANES, ring_geometry, ring_plan,
    tracer_ring_plan)

caar_t = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")

CSRC = os.path.join(os.path.dirname(caar_t.__file__), os.pardir, "csrc")
NLEVS = (26, 72, 150)


def _caar_source() -> str:
    with open(os.path.join(CSRC, "caar.cu")) as f:
        return f.read()


def _const(src: str, pattern: str) -> int:
    m = re.search(pattern, src)
    assert m, pattern
    return int(m.group(1))


def _read_span(ne: int, tile: int) -> tuple:
    """(first, last) tile that the sweep of each tile reads (the last tile
    ragged where e16 is not a multiple of the tile): the lanes of its
    groups, their alpha partners, their beta partners (16*ne lanes up
    from a j = 3 lane's group, back from a j = 0 lane's) and those
    partners' alpha partners, as ring::emit4 loads them."""
    e16 = 96 * ne * ne
    l0 = np.arange(0, e16, 4)
    e, i = l0 >> 4, (l0 >> 2) & 3
    ei, ej, rl = e % ne, (e // ne) % ne, 16 * ne
    da = np.where((i == 3) & (ei < ne - 1), 4,
                  np.where((i == 0) & (ei > 0), -4, 0))
    reads = [l0, l0 + 3, l0 + da, l0 + da + 3]
    up, dn = ej < ne - 1, ej > 0
    for ok, p in ((up, l0 + rl), (dn, l0 + 3 - rl)):
        reads += [np.where(ok, p, l0), np.where(ok, p + da, l0)]
    reads = np.stack(reads)
    assert reads.min() >= 0 and reads.max() < e16
    # by the tile of each group (the last tile may be ragged)
    t, owner = reads // tile, l0 // tile
    nb = -(-e16 // tile)
    first, last = np.full(nb, nb), np.full(nb, -1)
    np.minimum.at(first, owner, t.min(axis=0))
    np.maximum.at(last, owner, t.max(axis=0))
    return first, last


def _simulate(plan, resident: int, rng, first, last):
    """Run the schedule with `resident` blocks at once and random durations;
    returns the flag time of each tile, the end time of each ticket, the
    time each tile is discarded (by the last of its counted readers to end),
    the end of the last sweep that reads each tile, each tile's count and
    its reader total."""
    nb, h = plan.nb, plan.geo.halo
    flag = np.full(nb, np.nan)
    end = np.empty(plan.tickets)
    count = np.zeros(nb, np.int64)
    need = np.array([plan.readers(u) for u in range(nb)])
    gone = np.full(nb, np.nan)
    last_read = np.full(nb, -np.inf)
    ends = []                                  # a heap of running blocks
    for t in range(plan.tickets):
        start = 0.0 if t < resident else heapq.heappop(ends)
        now = start
        if t < nb:
            now += rng.uniform(1.0, 2.0)       # the CAAR tile
            flag[t] = now
        j = plan.sweeps(t)
        if j is not None:
            w = plan.waits(t)
            assert w.stop - 1 <= t and w.stop - 1 == min(j + h, nb - 1)
            # the flags waited on are set by lower or equal tickets, all
            # started: a wait on a later ticket would find no time here
            assert not np.isnan(flag[w.start:w.stop]).any()
            now = max(now, flag[w.start:w.stop].max())
            # the tiles the sweep reads lie inside its wait
            assert w.start <= first[j] and last[j] < w.stop
            now += rng.uniform(0.2, 0.6)       # the sweep
            last_read[first[j]:last[j] + 1] = np.maximum(
                last_read[first[j]:last[j] + 1], now)
            # the atomic counts land in time order: the count that
            # completes a tile is its latest reader's, who discards it
            count[w.start:w.stop] += 1
            gone[w.start:w.stop] = np.fmax(gone[w.start:w.stop], now)
        end[t] = now
        heapq.heappush(ends, now)
    return flag, end, gone, last_read, count, need


@pytest.mark.parametrize("ne", range(2, 33))
def test_torch_ring_schedule_never_discards_a_tile_early(ne):
    rng = np.random.default_rng(ne)
    first, last = _read_span(ne, caar_t.RING_TILE)
    plans = [ring_plan(96 * ne * ne, nlev, ne) for nlev in NLEVS]
    for nlev, plan in zip(NLEVS, plans):
        assert plan.caar == caar_t.caar_plan(96 * ne * ne, nlev)
        assert plan.geo.halo * caar_t.RING_TILE >= 16 * ne + 1
        assert (plan.nb, plan.geo) == (plans[0].nb, plans[0].geo)
    # the schedule depends on nlev only through the blocks an SM holds; the
    # plan's lag and none
    cards = {p.caar.blocks_per_sm * caar_t.SMS for p in plans}
    for plan in (plans[0], dataclasses.replace(plans[0], lag=0)):
        for resident in sorted({1, 2, 5} | cards):
            flag, end, gone, last_read, count, need = _simulate(
                plan, resident, rng, first, last)
            assert np.isfinite(end).all()       # every block finishes
            assert (count == need).all() and np.isfinite(gone).all()
            assert (gone >= last_read).all() and (gone >= flag).all()


def _launch_accepts(ncol: int, nlev: int, ne: int) -> bool:
    """caar_ring_launch's conditions on the shape (its operands aside), its
    constants read from csrc/caar.cu, the plan's chunks for any nlev."""
    src = _caar_source()
    tile = _const(src, r"constexpr int kRingTile = (\d+);")
    threads = _const(src, r"constexpr int kRingThreads = (\d+) \* kRingTile")
    max_nlev = _const(src, r"constexpr int kMaxNlev = (\d+);")
    max_smem = _const(src, r"constexpr size_t kMaxSmem = (\d+);")
    if nlev < 1 or ne < 1 or ncol < tile or ncol % tile or nlev > max_nlev:
        return False
    levels = -(-nlev // caar_t.CHUNKS)
    chunks = -(-nlev // levels)
    # the plan may take the stash or not: without it the least memory
    smem = (nlev + 3 * chunks) * tile * 4
    halo = ring_geometry(ne, tile).halo
    return (chunks <= threads and chunks * levels >= nlev
            and (chunks - 1) * levels < nlev and smem <= max_smem
            and halo * tile >= 16 * ne + 1)


@pytest.mark.parametrize("ncol,nlev,ne", [
    *((96 * ne * ne, nlev, ne) for ne in (2, 3, 7, 30, 32)
      for nlev in NLEVS),
    (86400, 400, 30), (86400, 401, 30), (86400, 0, 30), (16016, 72, 30),
    (48, 72, 1), (16, 8, 1), (0, 8, 1), (384, 72, 0), (96, 1, 1)])
def test_torch_ring_plan_refuses_what_the_launch_refuses(ncol, nlev, ne):
    accepts = _launch_accepts(ncol, nlev, ne)
    if accepts:
        plan = ring_plan(ncol, nlev, ne)
        tile = caar_t.RING_TILE
        assert plan.caar.tile == tile and plan.nb * tile == ncol
    else:
        with pytest.raises(ValueError):
            ring_plan(ncol, nlev, ne)


def test_torch_ring_kernel_constants_match_the_plan():
    """The ring kernel's tile, block and register cap in csrc/caar.cu are
    the plan's: the chunked kernel's 32 columns, 8 chunks, 3 blocks an SM
    at nlev 72 (the stash included)."""
    src = _caar_source()
    assert _const(src, r"constexpr int kRingTile = (\d+);") == \
        caar_t.RING_TILE == caar_t.TILE
    assert _const(src, r"constexpr int kRingThreads = (\d+) \* kRingTile") \
        * caar_t.RING_TILE == caar_t.RING_THREADS
    assert re.search(r"kRingBlocks = kRingTile == 32 \? (\d+)", src).group(1) \
        == "3"
    plan = ring_plan(86400, 72, 30)
    assert (plan.caar.blocks_per_sm, plan.caar.stash, plan.geo.halo,
            plan.lag, plan.nb, plan.tickets) == (3, True, 16, RING_LAG, 2700,
                                                 2716 + RING_LAG)


# -- the tracer ring ------------------------------------------------------

def _tracer_source() -> str:
    with open(os.path.join(CSRC, "tracer.cu")) as f:
        return f.read()


def _simulate_items(plan, resident: int, rng, first, last):
    """The tracer ring's schedule with `resident` blocks at once and random
    durations, in plain Python over items (group, tile) numbered c*nb +
    tile; returns, per item, its flag time, its count, its reader total,
    the time it is discarded (by the last of its counted readers to end)
    and the end of the last sweep that reads it, and each ticket's end."""
    nb, h, items = plan.nb, plan.geo.halo, plan.items
    flag = [None] * items
    count = [0] * items
    need = [plan.readers(i % nb) for i in range(items)]
    gone = [None] * items
    last_read = [float("-inf")] * items
    end, ends = [], []
    dur = rng.uniform(1.0, 2.0, plan.tickets).tolist()
    sweep = rng.uniform(0.2, 0.6, plan.tickets).tolist()
    for t in range(plan.tickets):
        now = 0.0 if t < resident else heapq.heappop(ends)
        made = plan.produces(t)
        if made is not None:
            assert made == divmod(t, nb)
            now += dur[t]
            flag[t] = now
        waits = plan.waits(t)
        if waits is not None:
            c, w = waits
            c_, j = plan.sweeps(t)
            assert c_ == c and w.stop - 1 == min(j + h, nb - 1)
            lo, hi = c * nb + w.start, c * nb + w.stop - 1
            # every tile waited on is of a lower or equal ticket, all
            # started: a wait on a later ticket would find no flag here
            assert hi <= t and all(flag[i] is not None
                                   for i in range(lo, hi + 1))
            now = max([now] + flag[lo:hi + 1])
            # the tiles the sweep reads lie inside its wait
            assert w.start <= first[j] and last[j] < w.stop
            now += sweep[t]
            for i in range(c * nb + first[j], c * nb + last[j] + 1):
                last_read[i] = max(last_read[i], now)
            for i in range(lo, hi + 1):
                count[i] += 1
                gone[i] = now if gone[i] is None else max(gone[i], now)
        end.append(now)
        heapq.heappush(ends, now)
    return flag, count, need, gone, last_read, end


# the card's residency for the tracer ring's 128-thread blocks: at the
# SM's thread limit (16 a SM) and a quarter of it
TRACER_RING_CARD = (caar_t.SMS * 4, caar_t.SMS * 16)


@pytest.mark.parametrize("ne", range(2, 33))
def test_torch_tracer_ring_schedule_never_discards_a_tile_early(ne):
    rng = np.random.default_rng(100 + ne)
    first, last = _read_span(ne, ring_fused.TILE)
    e16 = 96 * ne * ne
    for nlev, qsize in zip(NLEVS, (35, 1, 1)):
        plan = tracer_ring_plan(e16, nlev, ne, qsize)
        assert plan.lag == TRACER_RING_LAG
        assert plan.geo == ring_geometry(ne, ring_fused.TILE)
        assert plan.geo.halo * plan.geo.tile >= 16 * ne + 1
        chunks = -(-nlev // 8)
        assert (plan.group, plan.tracers) == (
            (min(chunks, 3), 1) if qsize == 1 else (1, 9))
        assert plan.items == -(-chunks // plan.group) * \
            -(-qsize // plan.tracers) * -(-e16 // 128)
        assert plan.tickets == plan.items + plan.geo.halo + plan.lag
        assert plan.state == 1 + 2 * plan.items
        # every item produced once and swept once
        made = [plan.produces(t) for t in range(plan.tickets)]
        swept = [plan.sweeps(t) for t in range(plan.tickets)]
        items = [divmod(i, plan.nb) for i in range(plan.items)]
        assert [m for m in made if m is not None] == items
        assert [s for s in swept if s is not None] == items
        for p in (plan, dataclasses.replace(plan, lag=0)):
            for resident in (1, 2, 5) + TRACER_RING_CARD:
                flag, count, need, gone, last_read, end = _simulate_items(
                    p, resident, rng, first, last)
                assert len(end) == p.tickets    # every block finishes
                assert count == need and None not in gone
                assert all(g >= r and g >= f for g, r, f in
                           zip(gone, last_read, flag))


@pytest.mark.parametrize("qsize", [1, 2, 3, 4, 5, 9, 10, 20, 35])
def test_torch_tracer_ring_items_hold_the_rows(qsize):
    """An item is the most chunks of every tracer that fit the first of
    TRACER_RING_ITEM_ROWS (all the column's where it has fewer), or one
    chunk of every tracer up to the second, or one chunk of the fewest
    tracers in equal groups that keep it to the second; the row blocks
    cover every level and tracer once."""
    group_rows, split_rows = ring_fused.TRACER_RING_ITEM_ROWS
    for nlev in (1, 8, 26, 72, 150):
        plan = tracer_ring_plan(86400, nlev, 30, qsize)
        g, n = plan.group, plan.tracers
        if 8 * qsize <= group_rows:
            assert n == qsize and 8 * n * g <= group_rows
            assert 8 * n * (g + 1) > group_rows or g == plan.chunks
        elif 8 * qsize <= split_rows:
            assert (g, n) == (1, qsize)
        else:
            ngt = -(-qsize // n)
            assert g == 1 and 8 * n <= split_rows and (ngt - 1) * n < qsize
            # fewer groups would need more rows an item
            assert 8 * -(-qsize // (ngt - 1)) > split_rows
        nl = -(-plan.chunks // g)
        assert (nl - 1) * 8 * g < nlev <= nl * 8 * g
        assert plan.blocks == nl * -(-qsize // n)


def _tracer_launch_accepts(ncol: int, nlev: int, ne: int, lag: int) -> bool:
    """tracer_ring_launch's conditions on the shape (its operands aside),
    its constants read from csrc/tracer.cu."""
    src = _tracer_source()
    tile = _const(src, r"constexpr int kTile = (\d+);")
    lanes = _const(src, r"constexpr int kRingLanes = (\d+);")
    assert (tile, lanes) == (ring_fused.TILE, TRACER_RING_LANES)
    assert _const(src, r"constexpr int kLevels = (\d+);") == \
        ring_fused._LEVELS
    if nlev < 1 or ne < 1 or ncol < lanes or ncol % lanes or lag < 0:
        return False
    return ring_geometry(ne, tile).halo * tile >= 16 * ne + 1


@pytest.mark.parametrize("ncol,nlev,ne,lag", [
    *((96 * ne * ne, nlev, ne, TRACER_RING_LAG) for ne in (1, 2, 3, 7, 30)
      for nlev in (1, *NLEVS)),
    (86400, 72, 30, 0), (86400, 72, 30, -1), (86400, 0, 30, 128),
    (86400, 72, 0, 128), (16016, 72, 30, 128), (16, 8, 1, 128),
    (0, 8, 1, 128), (32, 8, 1, 0), (160, 3, 1, 5)])
def test_torch_tracer_ring_plan_refuses_what_the_launch_refuses(ncol, nlev,
                                                                ne, lag):
    if _tracer_launch_accepts(ncol, nlev, ne, lag):
        plan = tracer_ring_plan(ncol, nlev, ne, lag=lag)
        assert plan.group >= 1
        assert plan.nb * ring_fused.TILE >= ncol > (plan.nb - 1) * \
            ring_fused.TILE
    else:
        with pytest.raises(ValueError):
            tracer_ring_plan(ncol, nlev, ne, lag=lag)


class _StubLibrary:
    """Stands in for a built library: records each launch's arguments and
    reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def launch(*args):
            self.calls.append((fn, args))
            return 0
        return launch


def test_torch_ring_wrappers_take_a_new_state_each_call(monkeypatch):
    """Both rings' CUDA branches (reached by checks that report a card, the
    launch stubbed): each call allocates a new launch state of the plan's
    size, the launch gets its pointer and length, and no argument of either
    launch is an epoch (every argument type is in the C signature, none
    unsigned)."""
    NL = 6
    const, s0, q, acc, plan, rsp = bench.make_prim_problem(2, NL, "cpu",
                                                           0.1, 2)
    scal, meta, pecnd, dvv = const
    fix = fix_tables(plan, "cpu")
    lib = _StubLibrary()
    states = []

    def new_state(ref, n):
        states.append(ring_fused._new_state.__wrapped__(ref, n))
        return states[-1]

    new_state.__wrapped__ = ring_fused._new_state
    cuda = types.SimpleNamespace(type="cuda", index=0)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(ring_fused, "_new_state", new_state)
    monkeypatch.setattr(ring_fused, "_stream", lambda dev: 0)
    monkeypatch.setattr(ring_fused, "_tracer_check", lambda *a, **kw: cuda)
    monkeypatch.setattr(ring_fused, "_caar_check", lambda *a, **kw: cuda)
    e16 = s0.shape[1]
    for _ in range(2):
        ring_fused.tracer_ring_packed_t(meta, s0, s0, q, dvv, 0.1, NL, rsp,
                                        fix, wind_rows=(0, 1))
        ring_fused.caar_ring_packed_t4(scal, meta, s0, s0, q[:NL], pecnd,
                                       *acc, dvv, rsp, fix)
    tplan = tracer_ring_plan(e16, NL, fix.ne, q.shape[0] // NL)
    cplan = ring_plan(e16, NL, fix.ne)
    sizes = [tplan.state, 1 + 2 * cplan.nb] * 2
    assert [x.numel() for x in states] == sizes
    assert len({x.data_ptr() for x in states}) == 4     # all alive: new
    for (fn, args), st in zip(lib.calls, states):
        sig = _build._SIGNATURES["tracer" if "tracer" in fn else "caar"][fn]
        assert len(args) == len(sig)
        assert _build.ctypes.c_uint not in sig
        i = args.index(st.data_ptr())
        assert args[i + 1] == st.numel()
    assert [fn for fn, _ in lib.calls] == ["tracer_ring_launch",
                                           "caar_ring_launch"] * 2
    for name in ("_STATE", "_CAAR_STATE", "_RingState", "_caar_state"):
        assert not hasattr(ring_fused, name)


# (ne, m, N) that the banded tests admit (tests/test_torch_banded.py,
# test_torch_banded_prim.py) and chip_smoke.py's phase 18
BANDED = ((4, 2, 4), (6, 3, 18), (8, 4, 8), (4, 2, 2), (4, 2, 12),
          (8, 4, 3), (8, 2, 6), (30, 2, 12), (32, 4, 6))


def _shards(ne, m, N):
    T = _banded_tables(collections.namedtuple("Plan", "ne")(ne), m, N)
    cps = T["cps"]
    return T, [T["first_last"][s * cps:(s + 1) * cps] for s in range(N)]


def _swept4_banded_emulated(x_ext, rsp, ne, bl, first_last):
    """The banded kernel's output from its group form in numpy f32: each
    thread's group of 4 lanes, its chunk, partner offsets and presence
    flags as dss_sweep::swept4_banded takes them, the sums and the scale in
    dss_sweep::swept4's order (the two-float scale fmaf(z, hi, z*lo), as
    ``dist.dss.mul_2f``)."""
    k, nch, rl = x_ext.shape[0], len(first_last), 16 * ne
    ext = bl + 2 * rl
    lo0 = np.arange(0, nch * bl, 4)
    c = lo0 // bl
    L0 = lo0 - c * bl
    i, ei = (L0 >> 2) & 3, (L0 >> 4) % ne
    da = np.where((i == 3) & (ei < ne - 1), 4,
                  np.where((i == 0) & (ei > 0), -4, 0))
    alpha = da != 0
    fl = np.asarray(first_last, bool)
    up = ~(fl[c, 1] & (L0 >= bl - rl))
    dn = ~(fl[c, 0] & (L0 < rl))
    pu = L0 + rl
    pd = L0 + 3 - rl + np.where(L0 < rl, ext, 0)
    base = c * ext
    X = x_ext.numpy()
    four = np.arange(4)
    cc = X[:, (base + L0)[:, None] + four]
    aa = X[:, (base + L0 + da)[:, None] + four]
    cc = np.where(alpha[:, None], cc + aa, cc)
    beta = lambda p: np.where(alpha, X[:, base + p] + X[:, base + p + da],
                              X[:, base + p])
    cc[:, :, 0] = np.where(dn, cc[:, :, 0] + beta(pd), cc[:, :, 0])
    cc[:, :, 3] = np.where(up, cc[:, :, 3] + beta(pu), cc[:, :, 3])
    r = rsp.numpy()[:, lo0[:, None] + four]
    if len(r) == 2:
        T = torch.from_numpy
        out = mul_2f(T(cc), T(r[0]), T(r[1])).numpy()
    else:
        out = cc * r[0]
    assert out.dtype == np.float32
    return out.reshape(k, nch * bl)


@pytest.mark.parametrize("ne,m,N", BANDED)
def test_torch_banded_layout_holds_on_every_decomposition(ne, m, N):
    T, shards = _shards(ne, m, N)
    rng = np.random.default_rng(ne * 100 + N)
    for fl in shards:
        lanes, ext = band_layout(ne, T["bl"], len(fl))
        assert (lanes, ext) == (len(fl) * T["bl"], T["ext"])
        g = np.arange(0, lanes, 4)
        assert ((g // T["bl"]) == ((g + 3) // T["bl"])).all()
        rows = np.arange(3)[:, None] * len(fl) + np.arange(len(fl))
        assert ((rows * ext * 4) % 16 == 0).all()
    # the group form against the plain banded sweep on two shards
    for fl in shards[:2]:
        for nr in (1, 2):
            x = torch.from_numpy(rng.standard_normal(
                (3, len(fl) * T["ext"])).astype(np.float32))
            rsp = torch.from_numpy(rng.uniform(
                0.5, 1.5, (nr, len(fl) * T["bl"])).astype(np.float32))
            want = _banded_plain(x, rsp, band_masks(ne, T["bl"], fl), len(fl),
                                 T["bl"], 16 * ne)
            got = _swept4_banded_emulated(x, rsp, ne, T["bl"], fl)
            assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("case", ["half row", "short band", "misaligned",
                                  "no rows"])
def test_torch_banded_wrapper_refuses_a_bad_layout(case, monkeypatch):
    """The CUDA branch (reached by operand checks that report a card)
    raises before it touches the card: a band that is not whole element
    rows (a group of 4 lanes could straddle two chunks, an x_ext row start
    off 16 bytes), a misaligned x_ext, an empty field."""
    ne, k = 4, 3
    rl = 16 * ne
    bl = {"half row": rl + 8, "short band": rl // 2}.get(case, 2 * rl)
    fix = types.SimpleNamespace(
        ne=ne, nfix=0, fix_col=torch.full((bl,), -1, dtype=torch.int32))
    bt = band_tables(fix, bl, [(True, False)])
    rows = 0 if case == "no rows" else k
    x = torch.zeros(rows * (bl + 2 * rl) + 1)
    x = (x[1:] if case == "misaligned" else x[:-1]).view(rows, bl + 2 * rl)
    rsp = torch.ones(1, bl)
    monkeypatch.setattr(dss, "_check_band", lambda *a, **kw: (
        torch.device("cuda", 0), None, 0.0, 0.0, False))
    match = {"misaligned": "16-byte", "no rows": "rows"}.get(case, "multiple")
    with pytest.raises(ValueError, match=match):
        dss_sweep_banded_nomerge_cuda(x, rsp, bt)
    with pytest.raises(ValueError, match=match):
        dss_sweep_banded_cuda(x, rsp, torch.zeros(rows, 0), bt)
