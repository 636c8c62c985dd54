"""The launch plans of the two kernels redesigned for the H100 (the sweep's
``sweep_plan``, the chunked CAAR kernel's ``caar_plan`` and the ring's
``caar_ring_plan``): pure functions of the shape that fit the card, the
wrappers' refusals of shapes the kernels do not take, the ctypes
signatures against the C sources, and the chunked CAAR kernel's summation
order repeated on the CPU against the JAX package (Pallas in interpret
mode, and caar_xla) within the on-card gate of 5e-5 scaled per field."""
import dataclasses
import importlib
import os
import re

import jax
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.kernels import caar_xla
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    _scalars as j_scalars,
    caar_pallas_packed_t4_lg,
    pack_problem_t as j_pack,
)
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.constants import CONSTANTS
from tinman_sandbox_tpu_torch.convert import from_numpy
from tinman_sandbox_tpu_torch.dist import (build_cubed_sphere,
                                           make_structured_plan)
from tinman_sandbox_tpu_torch.kernels import _build, dss, ring_fused
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_sweep_cuda, dss_sweep_nomerge_cuda, fix_tables, sweep_plan)
from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
from tinman_sandbox_tpu_torch.kernels.ring_fused import (TILE,
                                                         caar_ring_packed_t4)

caar_t = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")

torch.set_num_threads(2)

CAAR_TOL = 5e-5                  # chip_smoke.py's per-field gate
# (ncol, nlev): 1024 x 72, ne30 x 72, a small sphere (ne 2), a ragged
# column count (1001 elements: a warp of the last tile half live) and the
# deepest column the kernels take
SHAPES = ((16384, 72), (86400, 72), (384, 8), (16016, 72), (86400, 400))


@pytest.mark.parametrize("ncol,nlev", SHAPES)
def test_torch_caar_plan_is_pure_and_fits_the_card(ncol, nlev):
    plan = caar_t.caar_plan(ncol, nlev)
    caar_t.caar_plan.cache_clear()
    assert caar_t.caar_plan(ncol, nlev) == plan
    # the chunks depend on nlev alone: a shard (fewer columns) and the ring
    # sum every column in the same order
    for other in (16, 7200, ncol):
        p = caar_t.caar_plan(other, nlev)
        assert (p.chunks, p.levels) == (plan.chunks, plan.levels)
    ring = caar_t.caar_ring_plan(ncol, nlev)
    assert (ring.chunks, ring.levels, ring.tile, ring.stash) == (
        plan.chunks, plan.levels, TILE, False)
    for p, cap in ((plan, caar_t.CHUNK_THREADS), (ring, caar_t.RING_THREADS)):
        assert p.tile % 32 == 0 and p.threads == p.tile * p.chunks <= cap
        assert p.smem <= caar_t.SMEM_MAX
        assert p.blocks_per_sm >= 1
        assert p.blocks_per_sm * (p.smem + caar_t.SMEM_RESERVED) <= \
            caar_t.SM_SMEM
        assert p.blocks_per_sm * p.threads * p.regs <= caar_t.SM_REGS
        assert p.waves == pytest.approx(
            p.blocks / (caar_t.SMS * p.blocks_per_sm))
        assert p.blocks * p.tile >= p.ncol > (p.blocks - 1) * p.tile
    # every level in exactly one chunk, no empty chunk, in order
    ranges = plan.level_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == nlev
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.stash == (nlev <= 146)


def test_torch_caar_plan_at_the_main_shapes():
    """The plans chip_smoke.py prints: 8 chunks of 9 levels in tiles of 32
    columns with the stash, 3 blocks an SM; ne30 in 6.8 waves."""
    raw, ne30 = caar_t.caar_plan(16384, 72), caar_t.caar_plan(86400, 72)
    assert (ne30.tile, ne30.chunks, ne30.levels, ne30.stash) == (32, 8, 9,
                                                                 True)
    assert (raw.blocks_per_sm, ne30.blocks_per_sm) == (3, 3)
    assert raw.blocks == 512 and ne30.blocks == 2700
    assert ne30.waves == pytest.approx(2700 / 396)


@pytest.mark.parametrize("rows,e16", [(72, 86400), (288, 86400),
                                      (2520, 86400), (7, 384), (1, 16),
                                      (65535, 16)])
def test_torch_sweep_plan_is_pure_and_fits_the_card(rows, e16):
    plan = sweep_plan(rows, e16)
    sweep_plan.cache_clear()
    assert sweep_plan(rows, e16) == plan
    gx, gy = plan.grid
    assert plan.threads <= 1024 and gy <= 65535
    assert gx * plan.threads * 4 >= e16 > (gx - 1) * plan.threads * 4
    assert gy == rows                            # one row a thread
    assert plan.blocks == gx * gy
    assert plan.waves == pytest.approx(
        plan.blocks / (132 * plan.blocks_per_sm))
    # the register cap that keeps blocks_per_sm blocks an SM
    assert plan.blocks_per_sm * plan.threads <= 2048


@pytest.mark.parametrize("rows,e16", [(0, 384), (65536, 16), (8, 24),
                                      (8, 0)])
def test_torch_sweep_plan_refuses(rows, e16):
    with pytest.raises(ValueError):
        sweep_plan(rows, e16)


@pytest.mark.parametrize("ncol,nlev", [(384, 0), (384, 401), (24, 8),
                                       (0, 8)])
def test_torch_caar_plan_refuses(ncol, nlev):
    with pytest.raises(ValueError):
        caar_t.caar_plan(ncol, nlev)


@pytest.fixture(scope="module")
def ne2():
    cs = build_cubed_sphere(2, dtype=torch.float32, device="cpu")
    return cs, fix_tables(make_structured_plan(cs.gdof, cs.ne), "cpu")


@pytest.mark.parametrize("wrapper", ["dss_sweep_cuda",
                                     "dss_sweep_nomerge_cuda"])
def test_torch_sweep_wrappers_refuse_shapes_the_kernel_refuses(ne2, wrapper,
                                                               monkeypatch):
    """An empty field has no row block: on CPU tensors the plain version
    returns an empty field, and the wrapper's CUDA branch (reached here by
    a check that reports a card) raises before it touches the card."""
    _, fix = ne2
    x = torch.zeros(0, fix.e16)
    rsp = torch.ones(2, fix.e16)

    def call():
        if wrapper == "dss_sweep_cuda":
            return dss_sweep_cuda(x, rsp, torch.zeros(0, fix.nfix), fix)
        return dss_sweep_nomerge_cuda(x, rsp, fix)

    assert call().shape == (0, fix.e16)
    monkeypatch.setattr(dss, "_check",
                        lambda *a, **kw: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="rows"):
        call()


def _caar_operands(nelem, nlev):
    rng = np.random.default_rng(1)
    e16 = 16 * nelem
    z = lambda r: torch.from_numpy(rng.uniform(1, 2, (r, e16)).astype(
        np.float32))
    return (torch.zeros(1, 4), z(len(META_COLS)), z(4 * nlev), z(4 * nlev),
            z(nlev), z(nlev), z(nlev), z(nlev), z(nlev), torch.zeros(4, 4))


def test_torch_caar_wrappers_refuse_shapes_the_kernel_refuses(ne2,
                                                              monkeypatch):
    """nlev beyond the kernels' 400 levels: on CPU tensors the stacked entry
    runs the plain version; the CUDA branches of the stacked and the ring
    entry (reached here by a check that reports a card) raise before they
    touch the card."""
    args = _caar_operands(2, 401)
    got = caar_t.caar_t4_cuda(*args[:6], *(a.clone() for a in args[6:9]),
                              args[9])
    for g, w in zip(got, caar_t.caar_t4_plain(*args)):
        assert torch.equal(g, w)
    cuda = lambda *a, **kw: torch.device("cuda", 0)
    monkeypatch.setattr(caar_t, "_check", cuda)
    with pytest.raises(ValueError, match="nlev"):
        caar_t.caar_t4_cuda(*args)
    with pytest.raises(ValueError, match="nlev"):
        caar_t.caar_t4_cuda(*args[:3], None, *args[4:], single=True)
    cs, fix = ne2
    args = _caar_operands(cs.nelem, 401)
    monkeypatch.setattr(ring_fused, "_caar_check", cuda)
    with pytest.raises(ValueError, match="nlev"):
        caar_ring_packed_t4(*args, torch.ones(2, fix.e16), fix)


_CTYPES = {"void*": _build.ctypes.c_void_p, "int": _build.ctypes.c_int,
           "float": _build.ctypes.c_float, "unsigned": _build.ctypes.c_uint,
           "long long": _build.ctypes.c_longlong,
           "double": _build.ctypes.c_double,
           "int*": _build.ctypes.POINTER(_build.ctypes.c_int)}


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_torch_ctypes_signatures_match_the_c_sources(name):
    """Each function the wrappers call through ctypes has, in order, the
    argument types its C definition declares: a launch with one argument
    too few or of the wrong width fails only on the card."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    with open(os.path.join(csrc, _build.SOURCES[name])) as f:
        src = f.read()
    for fn, argtypes in _build._SIGNATURES[name].items():
        m = re.search(r"\b" + fn + r"\(([^)]*)\)\s*\{", src)
        assert m, fn
        types = []
        for p in m.group(1).split(","):
            p = re.sub(r"\s+", " ", p).replace("const ", "").strip()
            types.append(p[:p.index("*") + 1].replace(" ", "") if "*" in p
                         else p.rsplit(" ", 1)[0])
        assert [_CTYPES[t] for t in types] == list(argtypes), fn


# -- the chunked kernel's summation order on the CPU --------------------------

def _chunked_physics(scal, meta, dvv, s0, sm1, qdp, pecnd, plan, moist=True):
    """``caar_t4_plain``'s physics with the three vertical recurrences
    summed as csrc/caar.cu's chunked body sums them, in f32: each chunk's
    running sums start at the sum of the other chunks' totals, taken in
    chunk order (the dp prefix and the divdp prefix from the top, the q
    suffix from the bottom). Returns (s1, phi, vdp1, vdp2, omega_p)."""
    c = CONSTANTS
    k, e16 = qdp.shape
    ne = e16 // 16
    u, v, t, dp = s0.split(k)
    um1, vm1, tm1, dpm1 = sm1.split(k)
    dt2, h, rr = scal[0, 0], scal[0, 2], c.rrearth
    row = lambda name: meta[META_COLS.index(name)]
    dx = lambda s: torch.einsum("il,keij->kelj", dvv,
                                s.reshape(k, ne, 4, 4)).reshape(k, e16)
    dy = lambda s: torch.einsum("keji,il->kejl", s.reshape(k, ne, 4, 4),
                                dvv).reshape(k, e16)
    dinv00, dinv01 = row("dinv00"), row("dinv01")
    dinv10, dinv11 = row("dinv10"), row("dinv11")
    rmr = row("rmetdet") * rr

    def grad(s):
        g1, g2 = dx(s) * rr, dy(s) * rr
        return dinv00 * g1 + dinv10 * g2, dinv01 * g1 + dinv11 * g2

    gv1 = row("metdet") * (dinv00 * (u * dp) + dinv01 * (v * dp))
    gv2 = row("metdet") * (dinv10 * (u * dp) + dinv11 * (v * dp))
    divdp = (dx(gv1) + dy(gv2)) * rmr
    ranges = plan.level_ranges()

    def totals(x):
        out = []
        for lo, hi in ranges:
            acc = torch.zeros_like(x[0])
            for lev in range(lo, hi):
                acc = acc + x[lev]
            out.append(acc)
        return out

    def prefix(tot, c_):                       # sum of the chunks above
        acc = torch.zeros_like(tot[0])
        for cc in range(c_):
            acc = acc + tot[cc]
        return acc

    s_tot, p = totals(dp), torch.empty_like(dp)
    for c_, (lo, hi) in enumerate(ranges):
        s = prefix(s_tot, c_)
        for lev in range(lo, hi):
            s = s + dp[lev]
            p[lev] = (h + s) - 0.5 * dp[lev]
    tv = t * (1.0 + c.rgas_over_rvap_m1 * (qdp / dp)) if moist else t
    q = c.Rgas * tv * (dp / p)
    q_tot, phi = totals(q), torch.empty_like(q)
    for c_, (lo, hi) in enumerate(ranges):
        rsum = torch.zeros_like(q[0])
        for cc in range(len(ranges) - 1, c_, -1):
            rsum = rsum + q_tot[cc]
        for lev in range(hi - 1, lo - 1, -1):
            phi[lev] = (row("phis") + rsum) + 0.5 * q[lev]
            rsum = rsum + q[lev]
    d_tot, cum = totals(divdp), torch.empty_like(divdp)
    for c_, (lo, hi) in enumerate(ranges):
        acc = prefix(d_tot, c_)
        for lev in range(lo, hi):
            cum[lev] = acc
            acc = acc + divdp[lev]
    gp1, gp2 = grad(p)
    omega_p = (u * gp1 + v * gp2 - cum - 0.5 * divdp) / p
    vort = (dx(row("d01") * u + row("d11") * v)
            - dy(row("d00") * u + row("d10") * v)) * rmr
    gt1, gt2 = grad(t)
    ge1, ge2 = grad(0.5 * (u * u + v * v) + phi + pecnd)
    gpterm = c.Rgas * (tv / p)
    fv = row("fcor") + vort
    sph = row("spheremp")
    s1 = torch.cat([sph * (um1 + dt2 * (v * fv - ge1 - gpterm * gp1)),
                    sph * (vm1 + dt2 * (-(u * fv) - ge2 - gpterm * gp2)),
                    sph * (tm1 + dt2 * (-(u * gt1 + v * gt2)
                                        + c.kappa * tv * omega_p)),
                    sph * (dpm1 - dt2 * divdp)])
    return s1, phi, u * dp, v * dp, omega_p


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _problem(nelem, nlev, seed):
    cfg = jt.Config(nelem=nelem, nlev=nlev, elem_block=8, dt=600.0)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=seed))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 2)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(np.float32)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    geom = cast(jt.random_geometry(cfg, seed=seed + 1))
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    return cfg, st, dv, geom, hv


def _against_pallas_lg(nelem, nlev, seed):
    """Every output of the chunked order against caar_pallas_packed_t4_lg
    in interpret mode, and against the plain version (which sums each
    recurrence in one running sum), field by field."""
    cfg, st, dv, geom, hv = _problem(nelem, nlev, seed=seed)
    p = j_pack(st, dv, geom, hv, cfg)
    scal = np.asarray(j_scalars(np.float32(0.1), np.float32(0.7), hv))
    s0 = np.concatenate([np.asarray(p[n]) for n in ("u0", "v0", "t0", "dp0")])
    sm1 = np.concatenate([np.asarray(p[n])
                          for n in ("um1", "vm1", "tm1", "dpm1")])
    tail = [np.asarray(p[n]) for n in ("qdp", "pecnd", "vn0u", "vn0v", "omg")]
    ref = caar_pallas_packed_t4_lg(
        scal, p["dxbt"], p["dybt"], p["ainct"], p["astrt"], p["bstrt"],
        p["meta"], s0, sm1, *tail, nlev=nlev, lg=1, interpret=True)
    T = lambda x: torch.from_numpy(np.array(x))
    dvv = torch.from_numpy(np.asarray(geom.dvv, np.float32))
    args = (T(scal), T(p["meta"]), T(s0), T(sm1), *map(T, tail))
    plan = caar_t.caar_plan(16 * nelem, nlev)
    s1, phi, vdp1, vdp2, omega_p = _chunked_physics(
        args[0], args[1], dvv, args[2], args[3], args[4], args[5], plan)
    eta = args[0][0, 1]
    got = (s1, phi, args[6] + eta * vdp1, args[7] + eta * vdp2,
           args[8] + eta * omega_p)
    plain = caar_t.caar_t4_plain(*args, dvv)
    names = ("s1", "phi", "vn0u", "vn0v", "omg")
    for name, g, r, pl in zip(names, got, ref, plain):
        blocks = g.split(nlev) if name == "s1" else (g,)
        refs = np.split(np.asarray(r), 4) if name == "s1" else (r,)
        pls = pl.split(nlev) if name == "s1" else (pl,)
        for gb, rb, pb in zip(blocks, refs, pls):
            assert _err(gb, rb) < CAAR_TOL, (name, _err(gb, rb))
            assert _err(gb, pb) < CAAR_TOL, (name, _err(gb, pb))
    return plan


def test_torch_caar_chunked_order_matches_pallas_lg():
    """At nlev = 72 (8 chunks of 9 levels) on 8 elements."""
    plan = _against_pallas_lg(8, 72, seed=3)
    assert (plan.chunks, plan.levels) == (8, 9)


@pytest.mark.parametrize("nlev,chunks,levels,stash", [
    (26, 7, 4, True), (150, 8, 19, False)])
def test_torch_caar_chunked_order_other_nlev(nlev, chunks, levels, stash):
    """At nlev off the main path, on 8 elements: 26 (7 chunks, the last of
    2 levels) and 150 (the last chunk of 17 levels, no stash)."""
    plan = _against_pallas_lg(8, nlev, seed=4)
    assert (plan.chunks, plan.levels, plan.stash) == (chunks, levels, stash)
    assert plan.level_ranges()[-1] == ((chunks - 1) * levels, nlev)


def test_torch_caar_chunked_order_matches_caar_xla():
    """The chunked order through the full-state wrapper's packing against
    caar_xla, field by field, at nlev = 72."""
    nelem, nlev = 8, 72
    cfg, st, dv, geom, hv = _problem(nelem, nlev, seed=5)
    jst, jdv = caar_xla(st, dv, geom, hv, cfg, np.float32(0.1),
                        np.float32(0.5))
    np_ = lambda obj: {f.name: np.asarray(getattr(obj, f.name))
                       for f in dataclasses.fields(obj)}
    ts, td, tg, th = from_numpy(np_(st), np_(dv), np_(geom), np_(hv),
                                device="cpu")
    plan = caar_t.caar_plan(16 * nelem, nlev)

    def step(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp, pecnd,
             vn0u, vn0v, omg, dvv, moist=True):
        s1, phi, vdp1, vdp2, omega_p = _chunked_physics(
            scal, meta, dvv, torch.cat([u0, v0, t0, dp0]),
            torch.cat([um1, vm1, tm1, dpm1]), qdp, pecnd, plan, moist)
        eta = scal[0, 1]
        return (*s1.split(nlev), phi, vn0u + eta * vdp1, vn0v + eta * vdp2,
                omg + eta * omega_p)

    tcfg = Config(nelem=nelem, nlev=nlev, dt=600.0)
    ns, nd = caar_t.full_step(step, caar_t.T_PACKING, ts, td, tg, th, tcfg,
                              0.1, 0.5, device="cpu")
    for name in ("u", "v", "t", "dp3d"):
        e = _err(getattr(ns, name)[cfg.np1],
                 np.asarray(getattr(jst, name))[cfg.np1])
        assert e < CAAR_TOL, (name, e)
    for name in ("vn0_u", "vn0_v", "phi", "omega_p"):
        e = _err(getattr(nd, name), getattr(jdv, name))
        assert e < CAAR_TOL, (name, e)
