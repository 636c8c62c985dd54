"""The port's ring-fused path and sweep/patch split against the JAX
package's on the same numpy inputs, the JAX Pallas kernels in interpret
mode: the merge-free sweep, the split DSS, the three ring steps
(``caar_dss_ring_t4``, ``ssprk3_ring_t4``, ``ssprk3_tracer_ring_t``), the ring
geometry, the bench's ``--ring`` and the new wrappers' operand checks. On the
CPU the wrappers run their plain versions.

Tolerances. Without mix the merge-free sweep and the split DSS compute the
same f32 adds and products in the same order as the JAX kernels: bit for bit
with the single-f32 rspheremp, 1e-6 scaled with the two-float one and with
mix (XLA on the CPU contracts a product and a sum into one fused
multiply-add, the port rounds both, as tests/test_torch_rk.py states). The
ring steps: 3e-6 scaled per field for one assembled step (the CAAR
tendencies are summed in another order than the Pallas kernel's
matrix-unit contractions), 2e-5 for an SSPRK3 step and a tracer step (the
STEP_TOL of tests/test_torch_rk.py and tests/test_torch_tracer.py). Against
the port's own two-launch steps every ring step is bit for bit, and
continuity is exactly 0."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.dss import dss_project as j_dss_project
from tinman_sandbox_tpu.dist.step_pallas import (
    caar_dss_ring_t4 as j_caar_dss_ring,
    ssprk3_ring_t4 as j_ssprk3_ring,
    ssprk3_tracer_ring_t as j_tracer_ring,
)
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_lanes_2f
from tinman_sandbox_tpu.kernels.caar_pallas_t import _scalars as j_scalars
from tinman_sandbox_tpu.kernels.caar_pallas_t import pack_problem_t as j_pack
from tinman_sandbox_tpu.kernels.layout import pack_field_t as j_pack_field
from tinman_sandbox_tpu.kernels.dss_pallas import (
    _fixup_arrays,
    _fixup_arrays_t,
    cext_tables,
    dss_structured_t_pallas_patch,
    dss_sweeps_pallas_nomerge,
    extract_tiles_ct,
)
from tinman_sandbox_tpu_torch import bench
from tinman_sandbox_tpu_torch.convert import plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    build_cubed_sphere,
    caar_dss_ring_t4,
    caar_dss_ring_t4_plain,
    caar_dss_structured_packed_t4,
    continuity_error_t,
    ssprk3_packed_t4,
    ssprk3_ring_t4,
    ssprk3_ring_t4_plain,
    ssprk3_tracer_packed_t,
    ssprk3_tracer_ring_t,
    ssprk3_tracer_ring_t_plain,
)
from tinman_sandbox_tpu_torch.kernels import _build
from tinman_sandbox_tpu_torch.kernels.dss import (
    dss_extract_cuda,
    dss_merge_patch_cuda,
    dss_merge_patch_plain,
    dss_structured_t_cuda,
    dss_structured_t_cuda_patch,
    dss_structured_t_cuda_pre,
    dss_sweep_nomerge_cuda,
    dss_sweep_nomerge_plain,
    fix_tables,
)
from tinman_sandbox_tpu_torch.kernels.ring_fused import (
    caar_ring_packed_t4,
    ring_geometry,
    tracer_ring_packed_t,
)

torch.set_num_threads(2)
SWEEP_TOL = 1e-6
ASSEMBLED_TOL = 3e-6
STEP_TOL = 2e-5
NLEV = 4
DT = 0.02
# a tracer step long enough for f32 to resolve the increment q' - q
TRACER_DT = 1.0e4
WRAPPERS = (caar_ring_packed_t4, tracer_ring_packed_t, dss_sweep_nomerge_cuda,
            dss_merge_patch_cuda)


def _T(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _rsp(jcs, two_float):
    g = jcs.geometry
    if two_float:
        return np.ascontiguousarray(j_rsp_lanes_2f(
            np.asarray(g.spheremp, np.float32), jcs.gdof, jcs.ndof))
    return np.asarray(g.rspheremp, np.float32).reshape(1, -1)


def _problem(ne, seed):
    """A packed f32 problem on the ne cubed sphere for both packages: random
    state with the n0 level projected onto the continuous space, random
    accumulators and pecnd (``seed + 1``), three projected tracers, the
    two-float rspheremp. Returns a dict: "j" the JAX operands, "t" the
    port's tensors, the two plans, rsp and the grid."""
    jcs = j_build(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=NLEV, elem_block=8)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    gdof = jnp.asarray(jcs.gdof)

    def proj(x):
        return np.asarray(j_dss_project(jnp.asarray(x), gdof, jcs.ndof,
                                        g.spheremp, g.rspheremp), np.float32)

    def proj_n0(x):
        x = np.array(x)
        x[cfg.n0] = proj(x[cfg.n0])
        return x

    st = dataclasses.replace(st, u=proj_n0(st.u), v=proj_n0(st.v),
                             t=proj_n0(st.t), dp3d=proj_n0(st.dp3d))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 1)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(np.float32)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    p = j_pack(st, dv, g, hv, cfg)
    cat = lambda keys: np.concatenate([np.asarray(p[k]) for k in keys])
    s0, sm1 = cat(("u0", "v0", "t0", "dp0")), cat(("um1", "vm1", "tm1",
                                                    "dpm1"))
    # three tracers in [0, 1], each projected, packed tracer-major
    q = rng.uniform(0, 1, (3,) + st.u.shape[1:]).astype(np.float32)
    qdp = np.concatenate([np.asarray(j_pack_field(jnp.asarray(proj(x))))
                          for x in q])
    scal = np.asarray(j_scalars(np.float32(DT), np.float32(1.0), hv))
    acc = tuple(np.asarray(p[k]) for k in ("vn0u", "vn0v", "omg"))
    consts = tuple(p[k] for k in ("dxbt", "dybt", "ainct", "astrt", "bstrt",
                                  "meta"))
    jp = j_plan(jcs.gdof, ne)
    rsp = _rsp(jcs, True)
    return dict(
        j=(scal, consts, s0, sm1, np.asarray(p["qdp"]),
           np.asarray(p["pecnd"]), acc, qdp),
        t=(_T(scal), _T(p["meta"]), _T(s0), _T(sm1), _T(p["qdp"]),
           _T(p["pecnd"]), tuple(_T(a) for a in acc), _T(qdp),
           _T(np.asarray(g.dvv, np.float32))),
        jp=jp, plan=plan_from_fields(jp.ne, jp.edges, jp.corner_rows),
        rsp=rsp, jcs=jcs)


@pytest.fixture(scope="module", params=[2, 4])
def ring_case(request):
    """JAX's three ring steps on one problem, once per ne."""
    ne = request.param
    pr = _problem(ne, seed=30 + ne)
    scal, consts, s0, sm1, qdp, pecnd, acc, q3 = pr["j"]
    R = jnp.asarray(pr["rsp"])
    kw = dict(ne=ne, nlev=NLEV, interpret=True)
    pr["ref"] = dict(
        assembled=j_caar_dss_ring(scal, *consts, s0, sm1, qdp, pecnd, *acc,
                                  pr["jp"], R, **kw),
        ssprk3=j_ssprk3_ring(scal, *consts, s0, qdp, pecnd, *acc, pr["jp"],
                             R, **kw),
        tracer=np.asarray(j_tracer_ring(
            consts[0], consts[1], consts[5], s0, s0, q3, pr["jp"], R,
            jnp.float32(TRACER_DT), wind_rows=(0, 1), **kw)))
    return pr


def _fields(got, ref):
    names = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg")
    pairs = list(zip(got[0].split(NLEV), np.split(np.asarray(ref[0]), 4)))
    pairs += list(zip(got[1:], ref[1:]))
    return {n: _err(a, b) for n, (a, b) in zip(names, pairs)}


def _launches():
    return [w.launches for w in WRAPPERS]


def test_torch_caar_dss_ring_matches_jax(ring_case):
    """The ring-fused assembled step against JAX's ring at 3e-6 per field;
    bit for bit the port's two-launch step and its own plain twin;
    continuity 0; no launch counted on the CPU; accumulators in place."""
    scal, meta, s0, sm1, qdp, pecnd, acc, _, dvv = ring_case["t"]
    plan, R = ring_case["plan"], _T(ring_case["rsp"])
    counts = _launches()
    kacc = [a.clone() for a in acc]
    got = caar_dss_ring_t4(scal, meta, s0, sm1, qdp, pecnd, *kacc, dvv, plan,
                           R)
    assert _launches() == counts
    assert all(g is a for g, a in zip(got[2:], kacc))
    errs = _fields(got, ring_case["ref"]["assembled"])
    assert max(errs.values()) < ASSEMBLED_TOL, errs
    two = caar_dss_structured_packed_t4(scal, meta, s0, sm1, qdp, pecnd,
                                        *(a.clone() for a in acc), dvv, plan,
                                        R)
    plain = caar_dss_ring_t4_plain(scal, meta, s0, sm1, qdp, pecnd, *acc, dvv,
                                   plan, R)
    for a, b, c in zip(got, two, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert continuity_error_t(got[0], ring_case["jcs"].gdof) == 0.0


def test_torch_ssprk3_ring_matches_jax(ring_case):
    """The ring-fused SSPRK3 step against JAX's ring at 2e-5 per field;
    bit for bit ``ssprk3_packed_t4`` and the plain twin; continuity 0; s0
    untouched."""
    scal, meta, s0, _, qdp, pecnd, acc, _, dvv = ring_case["t"]
    plan, R = ring_case["plan"], _T(ring_case["rsp"])
    keep = s0.clone()
    got = ssprk3_ring_t4(scal, meta, s0, qdp, pecnd,
                         *(a.clone() for a in acc), dvv, plan, R)
    assert torch.equal(s0, keep)
    errs = _fields(got, ring_case["ref"]["ssprk3"])
    assert max(errs.values()) < STEP_TOL, errs
    two = ssprk3_packed_t4(scal, meta, s0, qdp, pecnd,
                           *(a.clone() for a in acc), dvv, plan, R)
    plain = ssprk3_ring_t4_plain(scal, meta, s0, qdp, pecnd, *acc, dvv, plan,
                                 R)
    for a, b, c in zip(got, two, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert continuity_error_t(got[0], ring_case["jcs"].gdof) == 0.0


def test_torch_ssprk3_tracer_ring_matches_jax(ring_case):
    """The ring-fused tracer step (3 tracers, winds read out of the state
    at wind_rows (0, 1)) against JAX's ring at 2e-5, field and increment;
    bit for bit ``ssprk3_tracer_packed_t(limit=False)`` and the plain twin;
    continuity 0."""
    _, meta, s0, _, _, _, _, q, dvv = ring_case["t"]
    plan, R = ring_case["plan"], _T(ring_case["rsp"])
    ref = ring_case["ref"]["tracer"]
    kw = dict(wind_rows=(0, 1))
    got = ssprk3_tracer_ring_t(dvv, meta, s0, s0, q, plan, R, TRACER_DT, NLEV,
                               **kw)
    assert _err(got, ref) < STEP_TOL
    assert _err(got - q, ref - q.numpy()) < STEP_TOL
    assert float((got - q).abs().max()) > 1e-3 * float(q.abs().max())
    two = ssprk3_tracer_packed_t(dvv, meta, s0, s0, q, plan, R, TRACER_DT,
                                 NLEV, limit=False, **kw)
    plain = ssprk3_tracer_ring_t_plain(dvv, meta, s0, s0, q, plan, R,
                                       TRACER_DT, NLEV, **kw)
    assert torch.equal(got, two) and torch.equal(got, plain)
    assert continuity_error_t(got, ring_case["jcs"].gdof) == 0.0


@pytest.mark.parametrize("step", ["assembled", "ssprk3", "tracer"])
def test_torch_ring_steps_equal_two_launch_at_odd_ne(step):
    """At ne 3, where JAX's ring cannot run (odd ne, E16 not a multiple of
    128), each ring step is bit for bit the port's two-launch step, with
    continuity 0."""
    const, s0, q, acc, plan, rsp = bench.make_prim_problem(3, NLEV, "cpu",
                                                           DT, 2)
    scal, meta, pecnd, dvv = const
    gdof = build_cubed_sphere(3, device="cpu").gdof
    if step == "tracer":
        args = (dvv, meta, s0, s0, q, plan, rsp, TRACER_DT, NLEV)
        got = ssprk3_tracer_ring_t(*args, wind_rows=(0, 1))
        two = (ssprk3_tracer_packed_t(*args, wind_rows=(0, 1)),)
        got = (got,)
    else:
        qdp = q[:NLEV]
        if step == "assembled":
            sm1 = torch.flip(s0, (1,)).contiguous()
            args = (scal, meta, s0, sm1, qdp, pecnd)
            ring, twin = caar_dss_ring_t4, caar_dss_structured_packed_t4
        else:
            args = (scal, meta, s0, qdp, pecnd)
            ring, twin = ssprk3_ring_t4, ssprk3_packed_t4
        got = ring(*args, *(a.clone() for a in acc), dvv, plan, rsp)
        two = twin(*args, *(a.clone() for a in acc), dvv, plan, rsp)
    for a, b in zip(got, two):
        assert torch.equal(a, b)
    assert continuity_error_t(got[0], gdof) == 0.0


@pytest.mark.parametrize("ne,two_float,mixed", [
    (2, False, False), (2, True, False), (3, False, False), (3, True, False),
    (2, False, True), (3, True, True)])
def test_torch_sweep_nomerge_matches_pallas(ne, two_float, mixed):
    """The merge-free sweep against ``dss_sweeps_pallas_nomerge``: bit for
    bit with the single-f32 rspheremp and no mix, else within 1e-6; every
    lane, fix lanes included; into a new tensor, and in place into a taller
    mix field whose further rows ride through."""
    jcs = j_build(ne)
    jp = j_plan(jcs.gdof, ne)
    plan = plan_from_fields(jp.ne, jp.edges, jp.corner_rows)
    rsp = _rsp(jcs, two_float)
    rng = np.random.default_rng(40 + ne)
    k, e16 = 6, jcs.nelem * 16
    x = rng.standard_normal((k, e16)).astype(np.float32)
    mx = rng.standard_normal((k, e16)).astype(np.float32)
    ca, cb = np.float32(1.0 / 3.0), np.float32(-0.7)
    jmix = (jnp.asarray(mx), ca, cb) if mixed else None
    ref = np.asarray(dss_sweeps_pallas_nomerge(
        jnp.asarray(x), jnp.asarray(rsp), ne, _fixup_arrays(jp)[4], mix=jmix,
        interpret=True))
    t = fix_tables(plan, "cpu")
    X, R = _T(x), _T(rsp)
    mix = (_T(mx), ca, cb) if mixed else None
    counts = _launches()
    got = dss_sweep_nomerge_cuda(X, R, t, mix)
    assert _launches() == counts
    if two_float or mixed:
        assert _err(got, ref) < SWEEP_TOL
    else:
        assert np.array_equal(got.numpy(), ref)
    assert torch.equal(got, dss_sweep_nomerge_plain(X, R, t, mix))
    # the fix lanes keep partial sums: the merged sweep differs there only
    merged = dss_structured_t_cuda(X, plan, R, mix)
    lanes = t.fix_lanes.long()
    other = torch.ones(e16, dtype=torch.bool)
    other[lanes] = False
    assert torch.equal(got[:, other], merged[:, other])
    assert not torch.equal(got[:, lanes], merged[:, lanes])
    # in place into a taller field
    tall = _T(np.concatenate([mx, x[:2]]))
    out = dss_sweep_nomerge_cuda(X, R, t, (tall, ca, cb))
    assert out is tall and torch.equal(tall[k:], X[:2])
    assert torch.equal(tall[:k], dss_sweep_nomerge_plain(X, R, t,
                                                         (_T(mx), ca, cb)))


@pytest.fixture(scope="module")
def split_case():
    """The ne 4 setup of tests/test_dss_compact.py:411: a random [40, E16]
    field, its compact slab, and JAX's split DSS with and without mix."""
    ne, k = 4, 40
    jcs = j_build(ne)
    jp = j_plan(jcs.gdof, ne)
    rsp = _rsp(jcs, False)
    rng = np.random.default_rng(44)
    e16 = jcs.nelem * 16
    x = rng.standard_normal((k, e16)).astype(np.float32)
    mx = rng.standard_normal((k, e16)).astype(np.float32)
    gtiles = _fixup_arrays_t(jp)[0]
    sf, nt, cM, cq = cext_tables(jp, e16 // 128)
    xs = extract_tiles_ct(jnp.asarray(x), gtiles, jnp.asarray(cq), cM,
                          interpret=True)
    mix = (jnp.asarray(mx), np.float32(0.75), np.float32(0.25))
    ref = [np.asarray(dss_structured_t_pallas_patch(
        jnp.asarray(x), xs, jp, jnp.asarray(rsp), mix=m, interpret=True))
        for m in (None, mix)]
    return dict(x=_T(x), mx=_T(mx), rsp=_T(rsp), ref=ref,
                plan=plan_from_fields(jp.ne, jp.edges, jp.corner_rows))


@pytest.mark.parametrize("mixed", [False, True])
def test_torch_split_dss_matches_pallas_patch(split_case, mixed):
    """``dss_structured_t_cuda_patch`` against JAX's split DSS: bit for bit
    without mix, within 1e-6 with it; bit for bit the port's merged DSS."""
    x, R, plan = split_case["x"], split_case["rsp"], split_case["plan"]
    mix = (split_case["mx"], np.float32(0.75), np.float32(0.25)) \
        if mixed else None
    t = fix_tables(plan, "cpu")
    slab = dss_extract_cuda(x, t)
    got = dss_structured_t_cuda_patch(x, slab, plan, R, mix)
    ref = split_case["ref"][int(mixed)]
    if mixed:
        assert _err(got, ref) < SWEEP_TOL
    else:
        assert np.array_equal(got.numpy(), ref)
    assert torch.equal(got, dss_structured_t_cuda_pre(x, slab, plan, R, mix))
    assert torch.equal(got, dss_structured_t_cuda(x, plan, R, mix))


@pytest.mark.parametrize("mixed", [False, True])
def test_torch_patch_touches_only_fix_lanes(split_case, mixed):
    """The patch alone, in place: every non-fix lane of w keeps its bits,
    every fix lane takes vd (or ca*mx + cb*vd); wrapper and plain agree."""
    x, plan = split_case["x"], split_case["plan"]
    t = fix_tables(plan, "cpu")
    k, e16 = x.shape
    rng = np.random.default_rng(45)
    w0 = _T(rng.standard_normal((k, e16)).astype(np.float32))
    vd = _T(rng.standard_normal((k, t.nfix)).astype(np.float32))
    ca, cb = np.float32(0.75), np.float32(0.25)
    mix = (split_case["mx"], ca, cb) if mixed else None
    w = w0.clone()
    out = dss_merge_patch_cuda(w, vd, t, mix)
    assert out is w
    lanes = t.fix_lanes.long()
    other = torch.ones(e16, dtype=torch.bool)
    other[lanes] = False
    assert torch.equal(w[:, other], w0[:, other])
    want = vd if not mixed else ca * split_case["mx"][:, lanes] + cb * vd
    assert torch.equal(w[:, lanes], want)
    assert torch.equal(w, dss_merge_patch_plain(w0.clone(), vd, t, mix))


@pytest.mark.parametrize("ne", [2, 3, 4, 30])
def test_torch_ring_geometry_covers_every_partner(ne):
    """Every lane a tile's sweep reads (alpha partner, beta partner and its
    alpha partner) lies within ``halo`` tiles of the tile; some lane reads
    exactly ``reach`` = db + 4 lanes away; at ne30 the reads span exactly 4
    tiles of 128 (at ne 2 a tile holds two whole faces and no read leaves
    it)."""
    geo = ring_geometry(ne)
    assert geo.db == 16 * ne - 3 and geo.reach == geo.db + 4
    e16 = 6 * ne * ne * 16
    lane = np.arange(e16)
    j, ej = lane % 4, (lane // (16 * ne)) % ne

    def alpha(l):
        ii, eii = (l // 4) % 4, (l // 16) % ne
        step = np.where((ii == 3) & (eii < ne - 1), 4,
                        np.where((ii == 0) & (eii > 0), -4, 0))
        return [l, l + step]

    beta = np.where((j == 3) & (ej < ne - 1), geo.db,
                    np.where((j == 0) & (ej > 0), -geo.db, 0))
    reads = alpha(lane) + alpha(lane + beta)
    dist = max(int(np.abs(r // geo.tile - lane // geo.tile).max())
               for r in reads)
    assert all(((r >= 0) & (r < e16)).all() for r in reads)
    assert max(int(np.abs(r - lane).max()) for r in reads) == geo.reach
    assert dist <= geo.halo
    if ne == 30:
        assert dist == geo.halo == 4


def test_torch_bench_ring_chain_equals_two_launch():
    """``run_assembled`` with the ring step on the CPU at ne 2 is bit for bit
    the two-launch run (two chained steps)."""
    const, levels, acc, plan, rsp = bench.make_assembled_problem(2, NLEV,
                                                                 "cpu")
    a = bench.run_assembled(const, levels, [x.clone() for x in acc], plan,
                            rsp, 2)
    b = bench.run_assembled(const, levels, [x.clone() for x in acc], plan,
                            rsp, 2, step=caar_dss_ring_t4)
    for x, y in zip((*a[0], *a[1], a[2]), (*b[0], *b[1], b[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("extra", [
    ["--rk"], ["--prim"], ["--layout", "row"], []])
def test_torch_bench_ring_refusals(extra, capsys):
    """``--ring`` is the assembled step's mode only: refused with --rk,
    --prim, --layout row and without --ne, before any device is touched."""
    argv = ["--ring"] + extra + (["--ne", "2"] if extra else [])
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == 2
    assert "--ring" in capsys.readouterr().err


def test_torch_bench_ring_bytes():
    """The ring's bytes: 21 CAAR rows with w in place of s1 (the s1 round
    trip leaves the count), two rspheremp rows, the slab written and read,
    the patch's fix values read and fix lanes written."""
    e16, slab = 86400, 2856 * 288
    got = bench.ring_bytes_per_step(30, 72, 2856)
    assert got == ((21 * 72 + 2) * e16 + 4 * slab) * 4
    assert bench.assembled_bytes_per_step(30, 72, 2856) - got == \
        (8 * 72 * e16 - 2 * slab) * 4


def _ring_operands():
    const, s0, q, acc, plan, rsp = bench.make_prim_problem(2, NLEV, "cpu",
                                                           DT, 2)
    return const, s0, q, acc, fix_tables(plan, "cpu"), rsp, plan


@pytest.mark.parametrize("case", [
    "sm1", "emit_phi", "rows", "mix", "tables", "rsp", "tracer_mix",
    "tracer_q", "sweep_mix", "sweep_overlap", "patch_mix", "patch_overlap",
    "patch_vd", "split_tall"])
def test_torch_ring_wrappers_reject_bad_operands(case):
    (scal, meta, pecnd, dvv), s0, q, acc, fix, rsp, plan = _ring_operands()
    qdp = q[:NLEV]
    e16 = s0.shape[1]
    caar = lambda **kw: caar_ring_packed_t4(
        scal, meta, kw.pop("s0", s0), kw.pop("sm1", s0), qdp, pecnd, *acc,
        dvv, kw.pop("rsp", rsp), kw.pop("fix", fix), **kw)
    x = torch.zeros(6, e16)
    vd = torch.zeros(6, fix.nfix)
    bad = {
        "sm1": (lambda: caar(sm1=None), "sm1 is required"),
        "emit_phi": (lambda: caar(emit_phi=False), "emit_phi=False"),
        "rows": (lambda: caar(s0=s0[:8], single=True), "rows"),
        "mix": (lambda: caar(mix=(s0[:8], 1.0, 1.0)), "mix field"),
        "tables": (lambda: caar(fix=fix_tables(
            bench.make_assembled_problem(3, 2, "cpu")[3], "cpu")), "tables"),
        "rsp": (lambda: caar(rsp=rsp[:, :16]), "rsp"),
        "tracer_mix": (lambda: tracer_ring_packed_t(
            meta, s0, s0, q, dvv, DT, NLEV, rsp, fix, wind_rows=(0, 1),
            mix=(q[:NLEV], 1.0, 1.0)), "mix field"),
        "tracer_q": (lambda: tracer_ring_packed_t(
            meta, s0, s0, q[:, :16], dvv, DT, NLEV, rsp, fix), "must be"),
        "sweep_mix": (lambda: dss_sweep_nomerge_cuda(
            x, rsp, fix, (torch.zeros(4, e16), 1.0, 1.0)), "mix field"),
        "sweep_overlap": (lambda: dss_sweep_nomerge_cuda(
            s0[:6], rsp, fix, (s0, 1.0, 1.0)), "overlaps"),
        "patch_mix": (lambda: dss_merge_patch_cuda(
            x, vd, fix, (torch.zeros(8, e16), 1.0, 1.0)), "mix field"),
        "patch_overlap": (lambda: dss_merge_patch_cuda(
            x, x.view(-1)[:6 * fix.nfix].view(6, fix.nfix), fix),
            "overlaps"),
        "patch_vd": (lambda: dss_merge_patch_cuda(x, vd[:, :5], fix),
                     "vd has shape"),
        "split_tall": (lambda: dss_structured_t_cuda_patch(
            x, dss_extract_cuda(x, fix), plan, rsp,
            (torch.zeros(8, e16), 1.0, 1.0)), "mix field"),
    }
    fn, match = bad[case]
    with pytest.raises(ValueError, match=match):
        fn()


def test_torch_build_hash_covers_headers(tmp_path):
    """A library's path hashes its source and every shared ``*.cuh``: an
    edit to a header moves every source's library, an edit to one source
    moves its own only."""
    csrc = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    headers = sorted(f for f in os.listdir(copy) if f.endswith(".cuh"))
    assert "dss_sweep.cuh" in headers and "ring.cuh" in headers
    paths = lambda: {n: _build._lib_path(n, str(copy)) for n in _build.SOURCES}
    before = paths()
    assert before == {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(copy / "ring.cuh", "a") as f:
        f.write("// edited\n")
    after = paths()
    assert all(after[n] != before[n] for n in _build.SOURCES)
    with open(copy / "caar.cu", "a") as f:
        f.write("// edited\n")
    last = paths()
    assert [n for n in _build.SOURCES if last[n] != after[n]] == ["caar"]
