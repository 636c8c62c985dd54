"""The launch plans of the kernels redesigned for the H100 (the sweep's
``sweep_plan``, the chunked CAAR kernel's ``caar_plan``, the ring's
``caar_ring_plan`` and the row kernel's ``caar_row_plan``): pure functions
of the shape that fit the card, the wrappers' refusals of shapes the
kernels do not take, the ctypes signatures against the C sources, and the
chunked CAAR kernel's summation order repeated on the CPU against the JAX
package (Pallas in interpret mode, and caar_xla) within the on-card gate of
5e-5 scaled per field; the row kernel's staging (a permutation into
swizzled planes: the t order bit for bit) and its rsplit=0 order against
the row Pallas kernels and, in f64, the port's plain step; the t layout's
rsplit=0 plan (``caar_plan(r0=True)``) and order: bit for bit the row
kernel's on the transposed problem, against its Pallas kernel and, in f64,
the port's plain step."""
import dataclasses
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.kernels import caar_xla
from tinman_sandbox_tpu.kernels.caar_pallas import (
    _scalars as j_row_scalars,
    caar_pallas_packed,
    caar_pallas_packed_rsplit0,
    pack_problem as j_row,
)
from tinman_sandbox_tpu.kernels.caar_pallas_t import (
    _scalars as j_scalars,
    caar_pallas_packed_rsplit0_t,
    caar_pallas_packed_t4_lg,
    pack_problem_t as j_pack,
)
from tinman_sandbox_tpu_torch import Config
from tinman_sandbox_tpu_torch.constants import CONSTANTS
from tinman_sandbox_tpu_torch.convert import from_numpy
from tinman_sandbox_tpu_torch.dist import (build_cubed_sphere,
                                           make_structured_plan)
from tinman_sandbox_tpu_torch.kernels import _build, dss, ring_fused
from tinman_sandbox_tpu.kernels.layout import pack_field as j_pack_field
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field_t
from tinman_sandbox_tpu_torch.kernels.caar import caar_packed_rsplit0_plain
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_sweep_cuda, dss_sweep_nomerge_cuda, fix_tables, sweep_plan)
from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
from tinman_sandbox_tpu_torch.kernels.ring_fused import caar_ring_packed_t4

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
    # the ring runs the chunked kernel's own plan on its own tile (whole
    # 128-byte lines of s1 a row: it refuses a ragged column count)
    if ncol % caar_t.RING_TILE:
        with pytest.raises(ValueError, match="multiple"):
            caar_t.caar_ring_plan(ncol, nlev)
        ring = plan
    else:
        ring = caar_t.caar_ring_plan(ncol, nlev)
        assert ring == plan and ring.tile == caar_t.RING_TILE
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

def _chunked_physics(scal, meta, dvv, s0, sm1, qdp, pecnd, plan, moist=True,
                     hyb=None):
    """``caar_t4_plain``'s physics with the three vertical recurrences
    summed as csrc/caar.cu's chunked body sums them, in f32: each chunk's
    running sums start at the sum of the other chunks' totals, taken in
    chunk order (the dp prefix and the divdp prefix from the top, the q
    suffix from the bottom). Returns (s1, phi, vdp1, vdp2, omega_p). With
    ``hyb`` ([nlev, 2]: hybi(k), hybi(k+1)) the body's rsplit=0 mode (kR0):
    sdot the chunks' divdp totals summed in chunk order, the interface
    fluxes with their forced zeros, the vertical advection of u, v and T,
    the dp tendency as (H(k+1) - H(k))*sdot (H(0) = 0, H(nlev) = 1), and
    eta_hi returned last."""
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
    if hyb is None:
        s1 = torch.cat([sph * (um1 + dt2 * (v * fv - ge1 - gpterm * gp1)),
                        sph * (vm1 + dt2 * (-(u * fv) - ge2 - gpterm * gp2)),
                        sph * (tm1 + dt2 * (-(u * gt1 + v * gt2)
                                            + c.kappa * tv * omega_p)),
                        sph * (dpm1 - dt2 * divdp)])
        return s1, phi, u * dp, v * dp, omega_p
    sdot = prefix(d_tot, len(ranges))
    lev = torch.arange(k)[:, None]
    top, bottom = lev > 0, lev < k - 1
    eta_lo = torch.where(top, hyb[:, 0:1] * sdot - cum, 0.0)
    eta_hi = torch.where(bottom, hyb[:, 1:2] * sdot - (cum + divdp), 0.0)
    rpdel = 1.0 / dp
    facp, facm = 0.5 * rpdel * eta_hi, 0.5 * rpdel * eta_lo

    def vadv(x):                               # x(k+1) and x(k-1), or x(k)
        nxt = torch.cat([x[1:], x[-1:]])
        prv = torch.cat([x[:1], x[:-1]])
        return facp * (nxt - x) + facm * (x - prv)

    dptens = (torch.where(bottom, hyb[:, 1:2], 1.0)
              - torch.where(top, hyb[:, 0:1], 0.0)) * sdot
    s1 = torch.cat([
        sph * (um1 + dt2 * (-vadv(u) + v * fv - ge1 - gpterm * gp1)),
        sph * (vm1 + dt2 * (-vadv(v) - (u * fv) - ge2 - gpterm * gp2)),
        sph * (tm1 + dt2 * (-vadv(t) - (u * gt1 + v * gt2)
                            + c.kappa * tv * omega_p)),
        sph * (dpm1 - dt2 * dptens)])
    return s1, phi, u * dp, v * dp, omega_p, eta_hi


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


# -- the row kernel: its staging and the rsplit=0 order ----------------------

def _span_at(i, nlev):
    """csrc/caar.cu's span_at: (column, level) of element i of a tile's span
    by the f32 quotient (i + 0.5) * (1/nlev)."""
    r = np.float32(1.0) / np.float32(nlev)
    q = ((i.astype(np.float32) + np.float32(0.5)) * r).astype(np.float32)
    cx = np.trunc(q).astype(np.int64)
    return cx, i - cx * nlev


def _swz(k, x):
    """csrc/caar.cu's swz: a plane's cell of column x at level k."""
    return k * caar_t.TILE + (x ^ (k & 31))


def _stage(x_row, nlev):
    """The row kernel's staging of one [E16, nlev] field: each tile's span
    (32 columns of nlev contiguous floats; the last tile may hold 16)
    copied element by element into a plane at swz(span_at(i)), and the
    passes' reads plane[swz(k, x)] gathered into [nlev, E16]."""
    e16 = x_row.shape[0]
    out = torch.empty(nlev, e16, dtype=x_row.dtype)
    for col0 in range(0, e16, caar_t.TILE):
        span = x_row[col0:col0 + caar_t.TILE].reshape(-1)
        i = np.arange(span.numel())
        cx, k = _span_at(i, nlev)
        plane = torch.full((caar_t.TILE * nlev,), float("nan"),
                           dtype=x_row.dtype)
        plane[torch.from_numpy(_swz(k, cx))] = span
        live = span.numel() // nlev
        kk, xx = np.meshgrid(np.arange(nlev), np.arange(live), indexing="ij")
        out[:, col0:col0 + live] = plane[torch.from_numpy(_swz(kk, xx))]
    return out


def _unstage(x_t):
    """The epilogue: element i of each tile's span written from the plane
    cell swz(span_at(i)) of the [nlev, E16] result; returns [E16, nlev]."""
    nlev, e16 = x_t.shape
    out = torch.empty(e16, nlev, dtype=x_t.dtype)
    for col0 in range(0, e16, caar_t.TILE):
        live = min(caar_t.TILE, e16 - col0)
        kk, xx = np.meshgrid(np.arange(nlev), np.arange(live), indexing="ij")
        plane = torch.empty(caar_t.TILE * nlev, dtype=x_t.dtype)
        plane[torch.from_numpy(_swz(kk, xx))] = x_t[:, col0:col0 + live]
        cx, k = _span_at(np.arange(live * nlev), nlev)
        out[col0:col0 + live] = plane[torch.from_numpy(_swz(k, cx))].reshape(
            live, nlev)
    return out


@pytest.mark.parametrize("nlev", [1, 8, 26, 72, 150, 197, 400])
def test_torch_row_staging_is_a_bank_free_permutation(nlev):
    """span_at's f32 quotient is the exact division for every element of a
    tile's span; swz maps a whole (32 columns) and a half-live (16) tile's
    span one to one into its plane; a warp of the passes (one level, 32
    columns) reads 32 banks, and a warp of the staging (32 consecutive
    floats) meets a bank at most twice where nlev >= 32 (a column boundary
    inside the warp)."""
    for live in (16, caar_t.TILE):
        i = np.arange(live * nlev)
        cx, k = _span_at(i, nlev)
        assert np.array_equal(cx, i // nlev) and np.array_equal(k, i % nlev)
        pos = _swz(k, cx)
        assert np.unique(pos).size == pos.size
        assert pos.min() >= 0 and pos.max() < caar_t.TILE * nlev
        if nlev >= 32:
            for w in range(0, pos.size, 32):
                assert np.bincount(pos[w:w + 32] % 32).max() <= 2
    for kk in range(nlev):
        banks = _swz(np.full(32, kk), np.arange(32)) % 32
        assert np.unique(banks).size == 32


def _wsw(w, x, window):
    """csrc/caar.cu's wsw: a window slot's cell of column x at level w."""
    return w * caar_t.TILE + (x ^ (w * (caar_t.TILE // window)))


@pytest.mark.parametrize("window", [4, 8, 16, 32])
@pytest.mark.parametrize("k0,k1", [(0, 50), (350, 400), (175, 198)])
def test_torch_row_window_is_a_bank_free_permutation(window, k0, k1):
    """The windowed row mode's copies: lane i of a warp's copy loop takes
    column i // window at window level i % window. Over the windows of a
    chunk [k0, k1) (the last one short) every (column, level) is copied
    once, to the cell the passes read it back from (lane x at level k reads
    wsw(k - win_lo, x)); a warp of copies (32 consecutive i) and a warp of
    the passes (one level, 32 columns) each meet 32 banks."""
    tile = caar_t.TILE
    seen = {}
    for kw in range(k0, k1, window):
        n = min(window, k1 - kw)
        i = np.arange(window * tile)
        cx, w = i // window, i % window
        cells = _wsw(w, cx, window)
        for j in range(0, i.size, 32):
            assert np.unique(cells[j:j + 32] % 32).size == 32
        keep = w < n
        assert np.unique(cells[keep]).size == keep.sum()
        for c, lv, cell in zip(cx[keep], w[keep], cells[keep]):
            seen[(int(c), kw + int(lv))] = int(cell)
        for lv in range(n):
            read = _wsw(np.full(tile, lv), np.arange(tile), window)
            assert np.unique(read % 32).size == 32
            for x in range(tile):
                assert seen[(x, kw + lv)] == read[x]
    assert len(seen) == tile * (k1 - k0)


def test_torch_row_plan_stages_where_the_planes_fit():
    """``caar_row_plan``: the t plan's chunks (so the t order), staged up to
    197 levels (161 at rsplit=0) and two blocks an SM at nlev 72 in both
    modes; windowed above (phi, the totals and each chunk's window slots
    in shared memory); the kernel's refusals are caar_plan's."""
    for r0, planes, top in ((False, 9, 197), (True, 11, 161)):
        assert caar_t.ROW_PLANES[r0] == planes
        for nlev in (26, 72, 150, 198, 400):
            p = caar_t.caar_row_plan(16016, nlev, r0)
            t = caar_t.caar_plan(16016, nlev)
            assert (p.chunks, p.levels, p.tile) == (t.chunks, t.levels, t.tile)
            assert p.row and p.r0 == r0 and p.stash == (nlev <= top)
            if not p.stash:
                slots = caar_t.ROW_WINDOW_SLOTS[r0] * caar_t.ROW_WINDOW
                assert p.smem == 4 * p.tile * (nlev + 3 * p.chunks
                                               + p.chunks * slots)
            assert p.smem <= caar_t.SMEM_MAX and p.blocks_per_sm >= 1
            assert p.blocks_per_sm * (p.smem + caar_t.SMEM_RESERVED) <= \
                caar_t.SM_SMEM
        assert caar_t.caar_row_plan(16, top, r0).stash
        assert not caar_t.caar_row_plan(16, top + 1, r0).stash
        assert caar_t.caar_row_plan(86400, 72, r0).blocks_per_sm == 2
    for ncol, nlev in ((384, 0), (384, 401), (24, 8)):
        with pytest.raises(ValueError):
            caar_t.caar_row_plan(ncol, nlev)


@pytest.mark.parametrize("nelem,nlev", [(8, 72), (7, 26)])
def test_torch_row_staged_order_is_the_t_order(nelem, nlev):
    """The row kernel's order on a row problem: its fields staged into the
    planes (a permutation: bit for bit the transposed fields, a half-live
    last tile at 7 elements), the chunked order, the epilogue back to
    [E16, nlev]; bit for bit the chunked order on the transposed problem,
    and within 5e-5 per field of caar_pallas_packed (the row Pallas kernel)
    in interpret mode."""
    cfg, st, dv, geom, hv = _problem(8, nlev, seed=6)
    p = j_row(st, dv, geom, hv, cfg)
    scal = np.asarray(j_row_scalars(np.float32(0.1), np.float32(0.7), hv))
    names = ("u0", "v0", "t0", "dp0", "um1", "vm1", "tm1", "dpm1", "qdp",
             "pecnd", "vn0u", "vn0v", "omg")
    ref = caar_pallas_packed(scal, p["dxb"], p["dyb"], p["ainc"], p["astr"],
                             p["bstr"], p["meta"], *(p[n] for n in names),
                             eb=8, nlev=nlev, interpret=True)
    e16 = 16 * nelem
    T = lambda x: torch.from_numpy(np.array(x))[:e16]
    rows = {n: T(p[n]) for n in names}
    staged = {n: _stage(x, nlev) for n, x in rows.items()}
    for n in names:
        assert torch.equal(staged[n], rows[n].T)
    meta = T(p["meta"]).T.contiguous()
    dvv = torch.from_numpy(np.asarray(geom.dvv, np.float32))
    plan = caar_t.caar_row_plan(e16, nlev)
    s = staged
    scal = torch.from_numpy(np.array(scal))
    s1, phi, vdp1, vdp2, omega_p = _chunked_physics(
        scal, meta, dvv,
        torch.cat([s[n] for n in names[:4]]),
        torch.cat([s[n] for n in names[4:8]]), s["qdp"], s["pecnd"], plan)
    eta = float(scal[0, 1])
    outs = [*s1.split(nlev), phi, s["vn0u"] + eta * vdp1,
            s["vn0v"] + eta * vdp2, s["omg"] + eta * omega_p]
    tplan = caar_t.caar_plan(e16, nlev)
    ts1, tphi, tv1, tv2, tom = _chunked_physics(
        scal, meta, dvv,
        torch.cat([rows[n].T for n in names[:4]]),
        torch.cat([rows[n].T for n in names[4:8]]), rows["qdp"].T,
        rows["pecnd"].T, tplan)
    touts = [*ts1.split(nlev), tphi, rows["vn0u"].T + eta * tv1,
             rows["vn0v"].T + eta * tv2, rows["omg"].T + eta * tom]
    for got, want, r in zip(outs, touts, ref):
        back = _unstage(got)
        assert torch.equal(back, want.T)
        assert _err(back, np.asarray(r)[:e16]) < CAAR_TOL


def _r0_problem(nelem, nlev, dtype):
    """The rsplit=0 problem of tests/test_torch_rsplit0.py: random state
    with a zero nm1 level and winds x 30 m/s, random accumulators, pecnd
    and eta_dot_dpdn, random geometry and a hybi ramp."""
    cfg = jt.Config(nelem=nelem, nlev=nlev, elem_block=8, rsplit=0)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, dtype), tree)
    st = cast(jt.random_state(cfg, seed=3))
    new = {}
    for name in ("u", "v", "t", "dp3d"):
        x = np.array(getattr(st, name))
        x[cfg.nm1] = 0
        if name in ("u", "v"):
            x *= 30.0
        new[name] = x
    st = dataclasses.replace(st, **new)
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(21)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, getattr(dv, n).shape).astype(dtype)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd", "eta_dot_dpdn")})
    geom = cast(jt.random_geometry(cfg, seed=4))
    hv = jt.analytic_hvcoord(cfg).astype(dtype)
    hv = dataclasses.replace(hv, hybi=np.linspace(0.0, 1.0, nlev + 1).astype(
        dtype))
    return cfg, st, dv, geom, hv


def _r0_chunked(p, scal, hyb, dvv, nlev, dtype):
    """The row kernel's rsplit=0 order on the packed row problem ``p``
    (staged: the t order on the transposed fields), as (u1, v1, t1, dp1,
    phi, vn0u, vn0v, omg, etaacc) on [E16, nlev]."""
    T = lambda x: torch.from_numpy(np.array(x, dtype))
    names = ("u0", "v0", "t0", "dp0", "um1", "vm1", "tm1", "dpm1")
    e16 = np.asarray(p["u0"]).shape[0]
    plan = caar_t.caar_row_plan(e16, nlev, r0=True)
    s1, phi, vdp1, vdp2, omega_p, eta_hi = _chunked_physics(
        T(scal), T(p["meta"]).T, T(dvv), torch.cat([T(p[n]).T
                                                    for n in names[:4]]),
        torch.cat([T(p[n]).T for n in names[4:]]), T(p["qdp"]).T,
        T(p["pecnd"]).T, plan, hyb=T(hyb).T)
    eta = T(scal)[0, 1]
    outs = (*s1.split(nlev), phi, T(p["vn0u"]).T + eta * vdp1,
            T(p["vn0v"]).T + eta * vdp2, T(p["omg"]).T + eta * omega_p,
            T(p["etaacc"]).T + eta * eta_hi)
    return [x.T for x in outs]


@pytest.mark.parametrize("nlev", [72, 26])
def test_torch_row_rsplit0_order_matches_pallas_and_plain(nlev):
    """The chunked body's rsplit=0 mode (kR0) on the row layout, hybi ramp
    and 30 m/s winds: in f32 within 5e-5 per field of
    caar_pallas_packed_rsplit0 in interpret mode; in f64 within 1e-12 of
    the port's plain rsplit=0 step (``caar_packed_rsplit0_plain``)."""
    names = ("u0", "v0", "t0", "dp0", "um1", "vm1", "tm1", "dpm1", "qdp",
             "pecnd", "vn0u", "vn0v", "omg")
    for dtype in (np.float32, np.float64):
        cfg, st, dv, geom, hv = _r0_problem(8, nlev, dtype)
        p = dict(j_row(st, dv, geom, hv, cfg, dtype=dtype))
        p["etaacc"] = j_pack_field(jnp.asarray(dv.eta_dot_dpdn, dtype)[:, 1:])
        hybi = np.asarray(hv.hybi, dtype)
        hyb = np.stack([hybi[:nlev], hybi[1:]])
        scal = np.asarray(j_row_scalars(dtype(0.1), dtype(0.7), hv, dtype))
        got = _r0_chunked(p, scal, hyb, geom.dvv, nlev, dtype)
        if dtype is np.float32:
            ref = caar_pallas_packed_rsplit0(
                scal, p["dxb"], p["dyb"], p["ainc"], p["astr"], p["bstr"],
                hyb, p["meta"], *(p[n] for n in names), p["etaacc"], eb=8,
                nlev=nlev, interpret=True)
            tol = CAAR_TOL
        else:
            T = lambda x: torch.from_numpy(np.array(x))
            ref = caar_packed_rsplit0_plain(
                T(scal), T(hyb), T(p["meta"]), *(T(p[n]) for n in names),
                T(p["etaacc"]), T(geom.dvv))
            tol = 1e-12
        for g, r in zip(got, ref):
            assert _err(g, r) < tol, (dtype, _err(g, r))


# -- the t layout's rsplit=0 kernel: its plan and order ---------------------

R0_NAMES = ("u0", "v0", "t0", "dp0", "um1", "vm1", "tm1", "dpm1", "qdp",
            "pecnd", "vn0u", "vn0v", "omg")


@pytest.mark.parametrize("ncol,nlev", SHAPES)
def test_torch_caar_r0_plan_is_pure_and_fits_the_card(ncol, nlev):
    """caar_plan(r0=True), row 6's launch: pure, the chunks and tile of
    the rsplit>0 plan and of the row rsplit=0 plan (so the row kernel's
    order), at the rsplit=0 kernels' register cap, the stash wherever two
    blocks an SM fit (146 levels), three blocks at the chunked kernel's cap
    where they fit and fill R0_WAVES waves (ne30 x 72, not 1024 x 72), and
    within the card's limits."""
    plan = caar_t.caar_plan(ncol, nlev, r0=True)
    caar_t.caar_plan.cache_clear()
    assert caar_t.caar_plan(ncol, nlev, r0=True) == plan
    t = caar_t.caar_plan(ncol, nlev)
    row = caar_t.caar_row_plan(ncol, nlev, r0=True)
    assert (plan.chunks, plan.levels, plan.tile) == \
        (t.chunks, t.levels, t.tile) == (row.chunks, row.levels, row.tile)
    assert plan.r0 and not plan.row
    assert plan.threads == plan.tile * plan.chunks <= caar_t.CHUNK_THREADS
    assert plan.smem <= caar_t.SMEM_MAX and plan.blocks_per_sm >= 1
    assert plan.blocks_per_sm * (plan.smem + caar_t.SMEM_RESERVED) <= \
        caar_t.SM_SMEM
    assert plan.blocks_per_sm * plan.threads * plan.regs <= caar_t.SM_REGS
    assert plan.stash == (nlev <= 146)
    # the instance capped for three blocks an SM: with the stash, where
    # three fit and the launch is at least R0_WAVES waves of them
    three = dataclasses.replace(plan, cap=caar_t.CHUNK_REGS)
    capped = plan.stash and three.blocks_per_sm == 3 and \
        three.waves >= caar_t.R0_WAVES
    assert plan.cap == (caar_t.CHUNK_REGS if capped else 0)
    assert plan.regs == (caar_t.CHUNK_REGS if capped else caar_t.ROW_REGS)
    assert plan.blocks_per_sm == (3 if capped else 2)
    if plan.stash:
        assert plan.smem == 4 * (6 * nlev + 3 * plan.chunks) * plan.tile


def test_torch_caar_r0_plan_at_the_main_shapes():
    """The t rsplit=0 plans chip_smoke.py prints: the stash at 2 blocks an
    SM at 1024 x 72 (1.9 waves), at 3 at ne30 x 72 (6.8 waves)."""
    raw, ne30 = caar_t.caar_plan(16384, 72, r0=True), \
        caar_t.caar_plan(86400, 72, r0=True)
    assert (raw.stash, raw.cap, raw.blocks_per_sm) == (True, 0, 2)
    assert (ne30.stash, ne30.cap, ne30.blocks_per_sm) == (True, 80, 3)


def _caar_launch_accepts(ncol: int, nlev: int) -> bool:
    """caar_launch's conditions on the shape at the t layout (its operands
    aside), its constants read from csrc/caar.cu, with the plan's chunks and
    the least shared memory (no stash)."""
    with open(os.path.join(os.path.dirname(_build.__file__), os.pardir,
                           "csrc", "caar.cu")) as f:
        src = f.read()
    const = lambda pat: int(re.search(pat, src).group(1))
    tile = const(r"constexpr int kChunkTile = (\d+);")
    threads = const(r"constexpr int kChunkThreads = (\d+);")
    max_nlev = const(r"constexpr int kMaxNlev = (\d+);")
    max_smem = const(r"constexpr size_t kMaxSmem = (\d+);")
    assert (tile, threads, max_nlev) == (caar_t.TILE, caar_t.CHUNK_THREADS,
                                         caar_t._MAX_NLEV)
    if ncol < 1 or ncol % 16 or nlev < 1 or nlev > max_nlev:
        return False
    levels = -(-nlev // caar_t.CHUNKS)
    chunks = -(-nlev // levels)
    return (tile * chunks <= threads
            and (nlev + 3 * chunks) * tile * 4 <= max_smem)


@pytest.mark.parametrize("ncol,nlev", [*SHAPES, (384, 0), (384, 401),
                                       (24, 8), (0, 8), (16, 1), (16, 400)])
def test_torch_caar_r0_plan_refuses_what_the_launch_refuses(ncol, nlev):
    if _caar_launch_accepts(ncol, nlev):
        plan = caar_t.caar_plan(ncol, nlev, r0=True)
        assert plan.blocks * plan.tile >= ncol
    else:
        with pytest.raises(ValueError):
            caar_t.caar_plan(ncol, nlev, r0=True)


@pytest.mark.parametrize("nlev", [72, 26, 150, 400])
def test_torch_t_rsplit0_order_is_the_row_order(nlev):
    """The t layout's rsplit=0 kernel's order (the chunked kR0 body on
    caar_plan(r0=True), row 6) at 8 elements, hybi ramp and 30 m/s winds:
    bit for bit the row kernel's order (row 8) on the JAX row packing of
    the same state, and within 5e-5 per field of
    caar_pallas_packed_rsplit0_t in interpret mode and of the port's plain
    step in f64 on the same f32 inputs."""
    cfg, st, dv, geom, hv = _r0_problem(8, nlev, np.float32)
    p = dict(j_pack(st, dv, geom, hv, cfg))
    eta_dot = jnp.asarray(dv.eta_dot_dpdn, np.float32)[:, 1:]
    p["etaacc"] = j_pack_field_t(eta_dot)
    hybi = np.asarray(hv.hybi, np.float32)
    hyb = np.stack([hybi[:nlev], hybi[1:]], axis=1)
    scal = np.asarray(j_scalars(np.float32(0.1), np.float32(0.7), hv))
    T = lambda x: torch.from_numpy(np.array(x, np.float32))
    plan = caar_t.caar_plan(16 * 8, nlev, r0=True)
    f = {n: T(p[n]) for n in (*R0_NAMES, "etaacc")}
    s1, phi, vdp1, vdp2, omega_p, eta_hi = _chunked_physics(
        T(scal), T(p["meta"]), T(geom.dvv),
        torch.cat([f[n] for n in R0_NAMES[:4]]),
        torch.cat([f[n] for n in R0_NAMES[4:8]]), f["qdp"], f["pecnd"],
        plan, hyb=T(hyb))
    eta = T(scal)[0, 1]
    got = (*s1.split(nlev), phi, f["vn0u"] + eta * vdp1,
           f["vn0v"] + eta * vdp2, f["omg"] + eta * omega_p,
           f["etaacc"] + eta * eta_hi)
    # the row kernel's order on the row packing of the same problem
    pr = dict(j_row(st, dv, geom, hv, cfg))
    pr["etaacc"] = j_pack_field(eta_dot)
    row = _r0_chunked(pr, scal, hyb.T, geom.dvv, nlev, np.float32)
    ref = caar_pallas_packed_rsplit0_t(
        scal, p["dxbt"], p["dybt"], p["ainct"], p["astrt"], p["bstrt"], hyb,
        p["meta"], *(p[n] for n in R0_NAMES), p["etaacc"], eb=8, nlev=nlev,
        interpret=True)
    D = lambda x: T(x).double()
    plain64 = caar_t.caar_packed_rsplit0_t_plain(
        D(scal), D(hyb), D(p["meta"]), *(f[n].double() for n in R0_NAMES),
        f["etaacc"].double(), D(geom.dvv))
    for g, r, pal, w in zip(got, row, ref, plain64):
        assert torch.equal(g, r.T)
        assert _err(g, pal) < CAAR_TOL, _err(g, pal)
        assert _err(g, w) < CAAR_TOL, _err(g, w)
