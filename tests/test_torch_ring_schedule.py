"""The schedules and layouts that the ring CAAR kernel and the banded sweep
kernel (``csrc/caar.cu``, ``csrc/ring.cuh``, ``csrc/dss.cu``) rely on, held
on the CPU where the kernels cannot run.

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
from tinman_sandbox_tpu_torch.kernels import dss
from tinman_sandbox_tpu_torch.kernels.dss import (
    _banded_plain, band_layout, band_masks, band_tables,
    dss_sweep_banded_cuda, dss_sweep_banded_nomerge_cuda)
from tinman_sandbox_tpu_torch.kernels.ring_fused import (RING_LAG,
                                                         ring_geometry,
                                                         ring_plan)

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
    """(first, last) tile that the sweep of each tile reads: the lanes of
    its groups, their alpha partners, their beta partners (16*ne lanes up
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
    t = (reads // tile).reshape(len(reads), -1, tile // 4)
    return t.min(axis=(0, 2)), t.max(axis=(0, 2))


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
    dss_sweep::swept4's order."""
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
    out = cc * r[0] + cc * r[1] if len(r) == 2 else cc * r[0]
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
