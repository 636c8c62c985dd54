"""The redesigned tracer kernels (``csrc/tracer.cu``: the Euler stage and the
limited stage in the quad layout) on the CPU, through the emulation of
their walk and arithmetic in ``kernels/tracer_t.py`` (the kernels run only
on the card, where ``chip_smoke.py`` phase 11 holds them to their plain
versions): ``tracer_euler_emulated`` and ``tracer_limit_emulated`` repeat the
kernels' grid over (128-lane tiles, level chunks split over the warps,
every tracer), the shared
wind-metric products c1 and c2, the quad's D_x order, the group sums (a
tree over a thread's 4 lanes, then over the quad) and a division once a
thread. The grid must write every (row, lane) and every slab entry exactly
once; the arithmetic must agree with JAX's Pallas kernels in interpret mode
and with the plain versions, and the limited stage must keep each element's
mass and its bounds.

Tolerances: 3e-6 scaled by max|b| + 1 for one f32 kernel call against
another summation order (the limit of tests/test_tracer_pallas.py and
tests/test_torch_tracer.py); 4e-6 of sum|w*y| for an element's mass and
1e-6 of max|q| for the bounds (chip_smoke.py's CONSERVE_TOL, BOUNDS_TOL).
"""
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.dss import dss_project as j_dss_project
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.kernels.dss_pallas import cext_tables
from tinman_sandbox_tpu.kernels.layout import (
    block_derivative_ops,
    pack_field_t as j_pack_field,
    pack_meta_t as j_pack_meta,
)
from tinman_sandbox_tpu.kernels.tracer_pallas_t import (
    tracer_euler_pallas_packed_t,
    tracer_limit_pallas_packed_t_ext,
)
from tinman_sandbox_tpu_torch.convert import plan_from_fields
from tinman_sandbox_tpu_torch.kernels import _build, ring_fused
from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
from tinman_sandbox_tpu_torch.kernels.dss import fix_tables
from tinman_sandbox_tpu_torch.kernels.tracer_t import (
    TRACER_LEVELS,
    TRACER_SKIP,
    TRACER_TILE,
    TRACER_WARPS,
    _check_aligned,
    _qsum,
    _warp_all,
    tracer_euler_emulated,
    tracer_euler_plain,
    tracer_limit_emulated,
    tracer_limit_plain,
)
from tinman_sandbox_tpu_torch.profiling import record_spans
from tinman_sandbox_tpu_torch.timeloop.rk import third_stage_weights

torch.set_num_threads(2)
KERNEL_TOL = 3e-6
CONSERVE_TOL = 4e-6
BOUNDS_TOL = 1e-6
CA, CB = np.float32(1.0 / 3.0), np.float32(2.0 / 3.0)


def _kerr(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else np.asarray(
        b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1.0)


def _T(a):
    return torch.from_numpy(np.array(a))


def _packed(ne, nlev, qsize, seed):
    """Packed f32 operands for both packages on the ne cubed sphere: random
    winds, a random qdp in [0, 1] projected onto the continuous space.
    Returns (JAX operands (dxbt, dybt, meta, vu, vv, q), the port's (meta,
    vu, vv, q, dvv), the JAX plan, the port's fix tables)."""
    jcs = j_build(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=nlev, qsize=qsize, elem_block=8)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    qdp = np.asarray(j_dss_project(
        jnp.asarray(st.qdp[0]), jnp.asarray(jcs.gdof), jcs.ndof, g.spheremp,
        g.rspheremp), np.float32)
    dxb, dyb = block_derivative_ops(8, g.dvv, np.float32)
    meta = np.asarray(j_pack_meta(g, st.phis, jnp.float32))
    pvu = np.asarray(j_pack_field(jnp.asarray(st.u[0])))
    pvv = np.asarray(j_pack_field(jnp.asarray(st.v[0])))
    q = np.concatenate([np.asarray(j_pack_field(jnp.asarray(qdp[:, i])))
                        for i in range(qsize)])
    jp = j_plan(jcs.gdof, ne)
    fix = fix_tables(plan_from_fields(jp.ne, jp.edges, jp.corner_rows),
                     "cpu")
    return ((jnp.asarray(dxb).T, jnp.asarray(dyb).T, jnp.asarray(meta),
             jnp.asarray(pvu), jnp.asarray(pvv), jnp.asarray(q)),
            (_T(meta), _T(pvu), _T(pvv), _T(q),
             _T(np.asarray(g.dvv, np.float32))), jp, fix)


def _scal(dt, ca=0.0, cb=0.0):
    return jnp.asarray([[dt, ca, cb, 0.0]], jnp.float32)


def _long_dt(meta, vu, vv, q, dvv, nlev):
    """A step at which dt*div(v q) is about half of q: at a short step the
    advective term sits below f32 resolution of q."""
    div = q - tracer_euler_plain(meta, vu, vv, q, dvv, 1.0, nlev,
                                 fold_sph=False)
    return float(np.float32(0.5 * float(q.abs().max())
                            / float(div.abs().max())))


def _squeezed(q, mx_seed):
    """q squeezed toward its element means, so that the advected value
    leaves the narrow bounds in many elements, and a mix field in [0, 1]."""
    el = q.reshape(q.shape[0], -1, 16)
    mean = el.mean(2, keepdim=True)
    q = (mean + 0.2 * (el - mean)).reshape(q.shape).contiguous()
    rng = np.random.default_rng(mx_seed)
    return q, _T(rng.uniform(0, 1, tuple(q.shape)).astype(np.float32))


def _once(writes, swrites, fix):
    assert torch.equal(writes, torch.ones_like(writes))
    if fix is None:
        assert swrites is None
    else:
        assert torch.equal(swrites, torch.ones_like(swrites))


# -- the grid: every (row, lane) and every slab entry exactly once ------------

@pytest.mark.parametrize("ne,nlev,qsize", [
    (2, 26, 3), (3, 72, 1), (4, 26, 35), (3, 5, 3), (4, 72, 3)])
@pytest.mark.parametrize("slab", [False, True])
def test_torch_tracer_kernels_write_every_entry_once(ne, nlev, qsize, slab):
    """Whole and ragged tiles (ne 2 and 4: 3 and 12 tiles of 128 lanes; ne
    3: a half-live last one), whole and ragged level chunks (nlev 5 and 26:
    warps with fewer levels or none), 1, 3 and 35 tracers: the
    emulated grid writes each output entry and each slab entry once, and
    the slab is the output at the fix lanes, bit for bit."""
    _, (meta, vu, vv, q, dvv), _, fix = _packed(ne, nlev, qsize, seed=ne)
    fix = fix if slab else None
    q, mx = _squeezed(q, ne)
    for out, sl, writes, swrites in (
            tracer_euler_emulated(meta, vu, vv, q, dvv, 7.5, nlev, fix=fix),
            tracer_limit_emulated(meta, vu, vv, q, dvv, 7.5, nlev,
                                  mix=(mx, CA, CB), fix=fix)):
        _once(writes, swrites, fix)
        assert bool(torch.isfinite(out).all())
        if fix is not None:
            assert torch.equal(sl, out[:, fix.read_lanes.long()].T)


# -- the arithmetic against JAX's kernels and the plain versions --------------

@pytest.mark.parametrize("ne,nlev,qsize,fold_sph", [
    (2, 26, 3, True), (4, 72, 1, True), (2, 26, 1, False)])
def test_torch_tracer_euler_emulated_matches_pallas(ne, nlev, qsize,
                                                    fold_sph):
    """The Euler stage as the kernel computes it against
    tracer_euler_pallas_packed_t in interpret mode and against
    tracer_euler_plain, at the run's dt and at a long one, per tracer."""
    (dxbt, dybt, jmeta, jvu, jvv, jq), (meta, vu, vv, q, dvv), _, _ = \
        _packed(ne, nlev, qsize, seed=11 + ne)
    for dt in (7.5, _long_dt(meta, vu, vv, q, dvv, nlev)):
        ref = np.asarray(tracer_euler_pallas_packed_t(
            _scal(dt), dxbt, dybt, jmeta, jvu, jvv, jq, eb=8, nlev=nlev,
            fold_sph=fold_sph, interpret=True))
        got = tracer_euler_emulated(meta, vu, vv, q, dvv, dt, nlev,
                                    fold_sph=fold_sph)[0]
        plain = tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev,
                                   fold_sph=fold_sph)
        for a, b, c in zip(got.split(nlev), np.split(ref, qsize),
                           plain.split(nlev)):
            assert _kerr(a, b) < KERNEL_TOL
            assert _kerr(a, c) < KERNEL_TOL


@pytest.mark.parametrize("ne,nlev,qsize,mix,iters,slab", [
    (2, 26, 1, False, 2, True), (2, 26, 3, True, 2, True),
    (4, 72, 1, True, 2, False), (2, 26, 3, False, 1, False),
    (2, 26, 1, True, 1, True)])
def test_torch_tracer_limit_emulated_matches_pallas(ne, nlev, qsize, mix,
                                                    iters, slab):
    """The limited stage as the kernel computes it against
    tracer_limit_pallas_packed_t_ext in interpret mode (as
    tests/test_torch_tracer.py runs it) and against tracer_limit_plain, per
    tracer, with and without the Shu-Osher combination, one and two
    limiter passes; the limiter did work (the unlimited value differs)."""
    (dxbt, dybt, jmeta, jvu, jvv, _), (meta, vu, vv, q, dvv), jp, fix = \
        _packed(ne, nlev, qsize, seed=19 + ne)
    q, mx = _squeezed(q, 20 + ne)
    # without the combination only the advective step can leave the bounds
    dt = 7.5 if mix else _long_dt(meta, vu, vv, q, dvv, nlev)
    sf, nt, cM, cq = cext_tables(jp, q.shape[1] // 128)
    ref, _ = tracer_limit_pallas_packed_t_ext(
        _scal(dt, CA, CB), dxbt, dybt, jmeta, jvu, jvv,
        jnp.asarray(q.numpy()), jnp.asarray(mx.numpy()) if mix else None,
        jnp.asarray(sf), nt=nt, nlev=nlev, has_mix=mix, cq=jnp.asarray(cq),
        cM=cM, iters=iters, interpret=True)
    tmix = (mx, CA, CB) if mix else None
    got, sl, writes, swrites = tracer_limit_emulated(
        meta, vu, vv, q, dvv, dt, nlev, mix=tmix, iters=iters,
        fix=fix if slab else None)
    _once(writes, swrites, fix if slab else None)
    plain = tracer_limit_plain(meta, vu, vv, q, dvv, dt, nlev, mix=tmix,
                               iters=iters)
    for a, b, c in zip(got.split(nlev), np.split(np.asarray(ref), qsize),
                       plain.split(nlev)):
        assert _kerr(a, b) < KERNEL_TOL
        assert _kerr(a, c) < KERNEL_TOL
    free = tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev)
    if mix:
        free = meta[11] * (float(CA) * mx + float(CB) * free / meta[11])
    assert _kerr(got, free) > 1e-4


@pytest.mark.parametrize("ne,nlev", [(2, 26), (4, 26)])
def test_torch_tracer_emulated_qsize35_matches_plain(ne, nlev):
    """E3SM's 35 tracers: both stages as the kernels compute them against
    the plain versions, tracer by tracer, with the combination."""
    _, (meta, vu, vv, q, dvv), _, _ = _packed(ne, nlev, 35, seed=31)
    q, mx = _squeezed(q, 32)
    dt = _long_dt(meta, vu, vv, q, dvv, nlev)
    pairs = [(tracer_euler_emulated(meta, vu, vv, q, dvv, dt, nlev)[0],
              tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev)),
             (tracer_limit_emulated(meta, vu, vv, q, dvv, dt, nlev,
                                    mix=(mx, CA, CB))[0],
              tracer_limit_plain(meta, vu, vv, q, dvv, dt, nlev,
                                 mix=(mx, CA, CB)))]
    for got, want in pairs:
        for a, b in zip(got.split(nlev), want.split(nlev)):
            assert _kerr(a, b) < KERNEL_TOL


# -- the limited stage's guarantees -------------------------------------------

@pytest.mark.parametrize("case", ["free", "mix", "uniform", "pushed"])
def test_torch_tracer_limit_emulated_conserves_and_bounds(case):
    """Per element and row the emulated limited stage keeps sum(w*y) of the
    value it was handed to 4e-6 of sum|w*y| and lands inside the bounds of
    the stage input wherever they are feasible to 1e-6 of max|q|; a uniform
    element (no room at all) stays finite and flat; pushed nodes are
    clipped."""
    nlev, qsize = 26, 3
    _, (meta, vu, vv, q, dvv), _, _ = _packed(2, nlev, qsize, seed=23)
    q, mx = _squeezed(q, 24)
    dt, tmix = 7.5, None
    if case == "free":
        dt = _long_dt(meta, vu, vv, q, dvv, nlev)
    elif case == "mix":
        tmix = (mx, np.float32(0.75), np.float32(0.25))
    elif case == "uniform":
        q = torch.full_like(q, 0.5)
        dt = _long_dt(meta, vu, vv, torch.rand_like(q), dvv, nlev)
    else:
        rng = np.random.default_rng(7)
        bump = _T((rng.random(tuple(q.shape)) < 0.1).astype(np.float32))
        tmix = (q + bump * _T(rng.choice([-1.0, 1.0], tuple(q.shape))
                              .astype(np.float32)), 1.0, 0.0)
        dt = 0.0
    w = meta[11]
    y_in = tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev, fold_sph=False)
    if tmix is not None:
        y_in = float(tmix[1]) * tmix[0] + float(tmix[2]) * y_in
    out = tracer_limit_emulated(meta, vu, vv, q, dvv, dt, nlev, mix=tmix)[0]
    assert bool(torch.isfinite(out).all())
    grp = lambda x: x.reshape(x.shape[0], -1, 16)
    wd = w.double()
    y = out.double() / wd
    m_in, m_out = grp(wd * y_in.double()).sum(2), grp(wd * y).sum(2)
    scale = grp((wd * y_in.double()).abs()).sum(2)
    assert float(((m_out - m_in).abs() / scale).max()) <= CONSERVE_TOL
    qmin, qmax = grp(q).amin(2).double(), grp(q).amax(2).double()
    wsum = grp(wd[None]).sum(2)
    feasible = (m_in >= wsum * qmin) & (m_in <= wsum * qmax)
    viol = (grp(y) - qmax[..., None]).clamp(min=0) \
        + (qmin[..., None] - grp(y)).clamp(min=0)
    if case == "uniform":
        assert float((grp(y).amax(2) - grp(y).amin(2)).max()) < 1e-4
    else:
        assert feasible.any()
        assert float(viol.amax(2)[feasible].max()) <= \
            BOUNDS_TOL * float(q.abs().max())
    if case == "pushed":
        assert float((y_in.double() - y).abs().max()) > 0.5


def _plain_counts(meta, vu, vv, q, dvv, dt, nlev, mix, iters):
    """``profiling.LIMITER_COUNTS`` of the plain limited stage."""
    with record_spans(counters=True) as rec:
        tracer_limit_plain(meta, vu, vv, q, dvv, dt, nlev, mix=mix,
                           iters=iters)
    return rec.limiter()


@pytest.mark.parametrize("case,iters", [
    ("free", 2), ("pushed", 2), ("pushed", 1), ("calm", 2), ("mix 3/4", 2),
    ("mix 3/4", 1), ("mix 1/3", 2)])
def test_torch_tracer_limit_skip_keeps_every_bit(case, iters):
    """Every limited instance skips a limiter pass in which no element of
    the warp (8 elements of a row) has a deficit: such a pass gives the
    clipped values bit for bit (pos false, give +-0, c +0), so the stage
    emulated with the skip equals it without, in the stage without mx and
    in the Shu-Osher stages with it (y = ca*mx + cb*e, (ca, cb) = (3/4,
    1/4) and (1/3, 2/3), mx the substep's input and q its first stage's
    output). In the first pass every warp has a deficit (free, mix 1/3),
    some do (pushed, mix 3/4) or none (calm: y = q). The plain limiter
    counts the passes as the kernels do: each warp's pass is computed, with
    a deficit, or skipped."""
    nlev, qsize = 26, 3
    _, (meta, vu, vv, q, dvv), _, fix = _packed(2, nlev, qsize, seed=41)
    dt, tmix = 0.0, None
    if case == "free":
        q, _ = _squeezed(q, 42)
        dt = _long_dt(meta, vu, vv, q, dvv, nlev)
    elif case == "pushed":
        rng = np.random.default_rng(43)
        bump = _T((rng.random(tuple(q.shape)) < 0.01).astype(np.float32))
        tmix = (q + bump, 1.0, 0.0)
        dt = 0.0
    elif case.startswith("mix"):
        qn, _ = _squeezed(q, 44)
        dt = _long_dt(meta, vu, vv, qn, dvv, nlev)
        q = tracer_euler_plain(meta, vu, vv, qn, dvv, dt, nlev,
                               fold_sph=False)
        ab = (np.float32(0.75), np.float32(0.25)) if case == "mix 3/4" \
            else third_stage_weights(np.float32)
        tmix = (qn, *ab)
    y = tracer_euler_plain(meta, vu, vv, q, dvv, dt, nlev, fold_sph=False)
    if tmix is not None:
        y = float(tmix[1]) * tmix[0] + float(tmix[2]) * y
    quads = lambda x: x.reshape(x.shape[0], -1, 4, 4)
    lo = quads(q).amin((2, 3), keepdim=True)
    hi = quads(q).amax((2, 3), keepdim=True)
    yq = quads(y)
    d = _qsum(meta[11].view(1, -1, 4, 4) * (yq - yq.clamp(lo, hi)))
    empty = _warp_all(d == 0)[:, ::8]
    assert (bool(empty.any()), bool((~empty).any())) == {
        "free": (False, True), "pushed": (True, True), "calm": (True, False),
        "mix 3/4": (True, True), "mix 1/3": (False, True)}[case]
    runs = [tracer_limit_emulated(meta, vu, vv, q, dvv, dt, nlev, mix=tmix,
                                  iters=iters, fix=fix, skip=skip)[:2]
            for skip in (False, True)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    n = _plain_counts(meta, vu, vv, q, dvv, dt, nlev, tmix, iters)
    assert n["warp_passes"] + n["warp_passes_skipped"] == empty.numel() * iters
    assert n["warp_passes_with_deficit"] == n["warp_passes"]
    first = int(empty.sum())
    if iters == 1:
        assert n["warp_passes_skipped"] == first
    else:
        # a second pass finds a deficit only where the first left a carry
        assert n["warp_passes_skipped"] > first
    if case == "calm":
        assert n["warp_passes"] == 0


def test_torch_tracer_skip_setting_mirrors_the_source():
    """The port's skip setting is one: ``TRACER_SKIP`` is csrc/tracer.cu's
    default (every limited instance skips), the emulation's default, and
    what the plain limiter's counts follow (the crafted pass below has a
    deficit in one warp of two)."""
    src = open(os.path.join(os.path.dirname(_build.__file__), "..", "csrc",
                            "tracer.cu")).read()
    default = re.search(r"#else\nconstexpr bool kSkipLimit = (true|false);"
                        r"\n#endif", src)
    assert default.group(1) == "true" and TRACER_SKIP is True
    assert "constexpr bool kSkip = kLimit && kSkipLimit;" in src
    sig = inspect.signature(tracer_limit_emulated)
    assert sig.parameters["skip"].default is TRACER_SKIP
    nel = 16
    meta = torch.zeros(len(META_COLS), nel * 16)
    meta[META_COLS.index("spheremp")] = 1.0
    q = torch.zeros(1, nel, 16)
    q[..., 5] = 1.0
    mx = q.clone()
    mx[0, 2, 9] = 1.5                  # element 2, in the first warp
    wind = torch.zeros(1, nel * 16)
    n = _plain_counts(meta, wind, wind, q.reshape(1, -1),
                      torch.eye(4), 0.0, 1, (mx.reshape(1, -1), 1.0, 0.0), 1)
    assert n == {"warp_passes": 1, "warp_passes_with_deficit": 1,
                 "warp_passes_skipped": 1, "element_passes_with_deficit": 1}


# -- what the wrappers and the build promise the kernels ----------------------

def test_torch_tracer_float4_operands_must_be_aligned():
    """The kernels move float4s: a view 4 bytes off a 16-byte boundary, a
    wind row block that starts off one, or a leading dimension that is not
    a multiple of 4 raises ValueError (no fallback)."""
    buf = torch.zeros(4 * 64 + 4)
    ok = buf[:256].view(4, 64)
    off = buf[1:257].view(4, 64)
    _check_aligned("t", 64, q=ok, vu=(ok, 2 * 64), mx=None)
    for kw in ({"q": off}, {"mx": off}, {"out": off}, {"vu": (ok, 1)},
               {"vv": (off, 64)}, {"fix_rank": torch.zeros(65, dtype=
                                                           torch.int32)[1:]}):
        with pytest.raises(ValueError, match="16-byte aligned"):
            _check_aligned("t", 64, **kw)
    with pytest.raises(ValueError, match="multiple of 4"):
        _check_aligned("t", 66, q=ok)


def test_torch_tracer_plan_and_flags_mirror_the_source():
    """The emulated grid is the kernels' (TRACER_LEVELS levels and
    TRACER_TILE lanes a block, TRACER_WARPS warps a stage), the ring
    kernel's tiles and row chunks are the same, and tracer.cu is built
    without FMA contraction, so the Euler and ring instances of its per-row
    body keep the same bits."""
    src = open(os.path.join(os.path.dirname(_build.__file__), "..", "csrc",
                            "tracer.cu")).read()
    levels = re.search(r"constexpr int kLevels = (\d+);", src)
    tile = re.search(r"constexpr int kTile = (\d+);", src)
    warps = re.search(r"constexpr int kWarpsEuler = (\d+), kWarpsLimit = "
                      r"(\d+);\n#endif", src)
    ring = re.search(r"constexpr int kRingWarps = (\d+);", src)
    assert int(levels.group(1)) == TRACER_LEVELS == ring_fused._LEVELS
    assert int(tile.group(1)) == TRACER_TILE == ring_fused.TILE == 32 * 4
    assert (int(warps.group(1)), int(warps.group(2))) == (
        TRACER_WARPS["euler"], TRACER_WARPS["limit"])
    assert int(ring.group(1)) * 32 == ring_fused.TILE   # a thread a lane
    assert "-fmad=false" in _build.SOURCE_FLAGS["tracer"]
