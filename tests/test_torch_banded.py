"""The port's multi-device DSS against the JAX package's on the same numpy
inputs, the JAX Pallas kernels in interpret mode on the 8-device CPU mesh of
tests/conftest.py: the plain versions of the banded sweeps and the tile
patch (``dss_sweeps_banded_t``, ``_ct``, ``_nomerge``, ``merge_patch_tiles``)
at their JAX signatures; the port's own operand form (chunk flags, shard fix
tables) against the JAX tables and kernels; the band- and face-sharded
assembled steps and the standalone banded DSS against JAX's and bit for bit
against the port's single-device step; the decompositions refused; the
wrappers' operand checks. On the CPU the wrappers run their plain versions.

Tolerances. Without mix and with the single-f32 rspheremp the banded sweeps
and the patch compute the same f32 adds and products in the same order as
the JAX kernels: bit for bit. With the two-float rspheremp or with mix they
are held at 1e-6 scaled (XLA on the CPU contracts a product and a sum into
one fused multiply-add where the port rounds both or contracts another
pair, as tests/test_torch_rk.py states). The assembled steps: 3e-6 scaled
per field (the CAAR tendencies are summed in another order than the Pallas
kernel's contractions, as in tests/test_torch_ring.py). Against the port's
single-device step every multi-device step is bit for bit, and continuity
is exactly 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tinman_sandbox_tpu as jt
from tinman_sandbox_tpu.dist import build_cubed_sphere as j_build
from tinman_sandbox_tpu.dist.banded_t4 import _banded_tables as j_band_tables
from tinman_sandbox_tpu.dist.banded_t4 import caar_dss_banded_t4 as j_banded
from tinman_sandbox_tpu.dist.banded_t4 import dss_banded_t as j_dss_banded
from tinman_sandbox_tpu.dist.dss import dss_project as j_dss_project
from tinman_sandbox_tpu.dist.sharded_t4 import caar_dss_sharded_t4 as j_sharded
from tinman_sandbox_tpu.dist.sharded_t4 import make_face_mesh as j_face_mesh
from tinman_sandbox_tpu.dist.structured_dss import make_structured_plan as j_plan
from tinman_sandbox_tpu.dist.structured_dss import rsp_lanes_2f as j_rsp_lanes_2f
from tinman_sandbox_tpu.kernels.caar_pallas_t import _scalars as j_scalars
from tinman_sandbox_tpu.kernels.caar_pallas_t import pack_problem_t as j_pack
from tinman_sandbox_tpu.kernels.dss_pallas import (
    dss_sweeps_banded_ct,
    dss_sweeps_banded_nomerge,
    dss_sweeps_banded_t,
    merge_patch_tiles,
)
from tinman_sandbox_tpu_torch.convert import plan_from_fields
from tinman_sandbox_tpu_torch.dist import (
    LocalMesh,
    caar_dss_banded_t4,
    caar_dss_banded_t4_plain,
    caar_dss_sharded_t4,
    caar_dss_sharded_t4_plain,
    caar_dss_structured_packed_t4,
    continuity_error_t,
    dss_banded_t,
    dss_banded_t_plain,
    dss_structured_t,
    make_face_mesh,
    shard_packed_t4,
    unshard_packed_t4,
)
from tinman_sandbox_tpu_torch.dist.banded_t4 import _band_shard, band_extend
from tinman_sandbox_tpu_torch.kernels.dss import (
    band_masks,
    dss_patch_tiles_cuda,
    dss_patch_tiles_plain,
    dss_sweep_banded_cuda,
    dss_sweep_banded_nomerge_cuda,
    dss_sweep_banded_nomerge_plain,
    dss_sweep_banded_plain,
)

torch.set_num_threads(2)
SWEEP_TOL = 1e-6
ASSEMBLED_TOL = 3e-6
NLEV = 4
DT = 0.02
WRAPPERS = (dss_sweep_banded_cuda, dss_sweep_banded_nomerge_cuda,
            dss_patch_tiles_cuda)
FIRST, MID, LAST = (True, False), (False, False), (False, True)
CA, CB = np.float32(1.0 / 3.0), np.float32(2.0 / 3.0)


def _T(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _hold(got, want, exact):
    if exact:
        assert np.array_equal(np.asarray(got), np.asarray(want))
    else:
        assert _err(got, want) < SWEEP_TOL


def _plans(ne):
    jcs = j_build(ne)
    jp = j_plan(jcs.gdof, ne)
    return jcs, jp, plan_from_fields(jp.ne, jp.edges, jp.corner_rows)


# -- the kernels at the JAX signatures ---------------------------------------

def _band_inputs(ne, m, chunks, k, nr, seed):
    """Numpy operands of the JAX banded sweeps for the chunk variants
    ``chunks``: x_ext, rsp (two-float: a hi row and a ~1e-8 lo row), the
    masks, the merge mask, tile-dense vals and the compact vals (values at
    the variant's merged lanes only, zeros elsewhere, as JAX's fixup leaves
    them)."""
    _, jp, _ = _plans(ne)
    T = j_band_tables(jp, m)
    rng = np.random.default_rng(seed)
    n, bl, ext, wd, wr = len(chunks), T["bl"], T["ext"], T["wd"], T["wr"]
    rsp = rng.uniform(0.5, 1.5, (nr, n * bl)).astype(np.float32)
    if nr == 2:
        rsp[1] *= 1e-8
    dm = np.concatenate([T["dmv"](*c) for c in chunks], axis=1)
    vd_c = np.zeros((k, n * wr), np.float32)
    for c in range(n):
        for i, d in enumerate(T["dense_pat"]):
            if dm[0, c * wd + d]:
                vd_c[:, c * wr + T["cpat"][i]] = rng.standard_normal(k)
    return dict(
        T=T, x_ext=rng.standard_normal((k, n * ext)).astype(np.float32),
        rsp=rsp, dm=dm, vals=rng.standard_normal((k, n * wd)).astype(
            np.float32), vd_c=vd_c,
        masks=jnp.concatenate([T["maskv"](*c) for c in chunks], axis=1),
        mx=rng.standard_normal((k + 2 * NLEV, n * bl)).astype(np.float32))


SWEEP_CASES = [
    # ne, m, chunks, rsp rows, mix (None, "k" rows or "taller"), compact
    (4, 2, (FIRST, LAST), 1, None, False),
    (4, 2, (FIRST, LAST), 1, None, True),
    (6, 3, (FIRST, MID, LAST), 1, None, True),
    (8, 4, (FIRST, MID, MID, LAST), 2, None, False),
    (8, 4, (FIRST, MID, MID, LAST), 1, "k", True),
    (6, 3, (FIRST, MID, LAST), 2, "taller", False),
]


@pytest.mark.parametrize("ne,m,chunks,nr,mixed,compact", SWEEP_CASES)
def test_torch_sweep_banded_plain_matches_pallas(ne, m, chunks, nr, mixed,
                                                  compact):
    """``dss_sweep_banded_plain`` against ``dss_sweeps_banded_t`` (dense
    vals) and ``dss_sweeps_banded_ct`` (compact vals, one-hot placement)
    over every chunk variant, with mix into a k-row and a taller mx (its
    further rows kept), single and two-float rspheremp."""
    k = 3 * NLEV
    d = _band_inputs(ne, m, chunks, k, nr, seed=ne + 10 * m + nr)
    T, n = d["T"], len(chunks)
    mx = None if mixed is None else d["mx"][:k] if mixed == "k" else d["mx"]
    jmix = None if mx is None else (jnp.asarray(mx), jnp.float32(CA),
                                    jnp.float32(CB))
    tmix = None if mx is None else (_T(mx), CA, CB)
    kw = dict(nchunks=n, bl=T["bl"], rl=T["rl"])
    if compact:
        want = dss_sweeps_banded_ct(
            d["x_ext"], d["rsp"], d["vd_c"], T["qc"], d["dm"], d["masks"],
            T["tiles"], m_rows=T["Mc"], mix=jmix, interpret=True, **kw)
        got = dss_sweep_banded_plain(
            _T(d["x_ext"]), _T(d["rsp"]), _T(d["vd_c"]), d["dm"],
            np.asarray(d["masks"], np.float32), T["tiles"], mix=tmix,
            p_tbl=np.asarray(T["qc"], np.float32), m_rows=T["Mc"], **kw)
    else:
        want = dss_sweeps_banded_t(
            d["x_ext"], d["rsp"], d["vals"], d["dm"], d["masks"], T["tiles"],
            mix=jmix, interpret=True, **kw)
        got = dss_sweep_banded_plain(
            _T(d["x_ext"]), _T(d["rsp"]), _T(d["vals"]), d["dm"],
            np.asarray(d["masks"], np.float32), T["tiles"], mix=tmix, **kw)
    assert got.shape == want.shape
    _hold(got, want, nr == 1 and mx is None)
    if mixed == "taller":
        assert np.array_equal(got[k:].numpy(), mx[k:])


@pytest.mark.parametrize("ne,m,chunks,nr,mixed", [
    (4, 2, (FIRST, LAST), 1, None),
    (8, 4, (FIRST, MID, MID, LAST), 2, "k"),
    (6, 3, (FIRST, MID, LAST), 1, "taller"),
])
def test_torch_sweep_banded_nomerge_plain_matches_pallas(ne, m, chunks, nr,
                                                          mixed):
    """``dss_sweep_banded_nomerge_plain`` against
    ``dss_sweeps_banded_nomerge``: every band lane, fix lanes included."""
    k = 3 * NLEV
    d = _band_inputs(ne, m, chunks, k, nr, seed=5 * ne + m)
    T = d["T"]
    mx = None if mixed is None else d["mx"][:k] if mixed == "k" else d["mx"]
    kw = dict(nchunks=len(chunks), bl=T["bl"], rl=T["rl"])
    want = dss_sweeps_banded_nomerge(
        d["x_ext"], d["rsp"], d["masks"], interpret=True,
        mix=None if mx is None else (jnp.asarray(mx), jnp.float32(CA),
                                     jnp.float32(CB)), **kw)
    got = dss_sweep_banded_nomerge_plain(
        _T(d["x_ext"]), _T(d["rsp"]), np.asarray(d["masks"], np.float32),
        mix=None if mx is None else (_T(mx), CA, CB), **kw)
    _hold(got, want, nr == 1 and mx is None)


@pytest.mark.parametrize("taller,mixed", [(False, False), (True, False),
                                          (True, True)])
def test_torch_patch_tiles_plain_matches_pallas(taller, mixed):
    """``dss_patch_tiles_plain`` against ``merge_patch_tiles`` on a
    multi-chunk shard (ne 8, m 4, chunks first, middle, middle, last): the
    merged lanes of the fix tiles of w's first k rows rewritten, a taller
    w's further rows and every other lane kept; with mix ca*mx + cb*value."""
    _, jp, _ = _plans(8)
    T = j_band_tables(jp, 4)
    chunks = (FIRST, MID, MID, LAST)
    ntb, Mc, bl = len(T["tiles"]), T["Mc"], T["bl"]
    gtiles = tuple(c * (bl // 128) + t for c in range(4) for t in T["tiles"])
    k = 3 * NLEV
    rng = np.random.default_rng(30 + taller + 2 * mixed)
    w = rng.standard_normal((k + NLEV * taller, 4 * bl)).astype(np.float32)
    vals3 = rng.standard_normal((len(gtiles), Mc, k)).astype(np.float32)
    dm = np.concatenate([T["dmv"](*c) for c in chunks], axis=1)
    mx = rng.standard_normal(w.shape).astype(np.float32)
    want = merge_patch_tiles(
        w, vals3, T["qc"], dm, gtiles, ntb, Mc, interpret=True,
        mix=(jnp.asarray(mx), jnp.float32(CA), jnp.float32(CB)) if mixed
        else None)
    got = dss_patch_tiles_plain(
        _T(w), _T(vals3), np.asarray(T["qc"], np.float32), dm, gtiles, ntb,
        Mc, mix=(_T(mx), CA, CB) if mixed else None)
    _hold(got, want, not mixed)
    changed = np.any(np.asarray(got) != w, axis=0)
    assert changed.sum() > 0 and np.array_equal(got[k:].numpy(), w[k:])


# -- the port's operand form against the JAX tables --------------------------

@pytest.mark.parametrize("ne,m", [(4, 2), (6, 3), (8, 4)])
def test_torch_band_masks_match_jax(ne, m):
    """``band_masks`` of each chunk variant is JAX's ``maskv``."""
    _, jp, _ = _plans(ne)
    T = j_band_tables(jp, m)
    for c in (FIRST, MID, LAST):
        assert np.array_equal(band_masks(ne, T["bl"], [c]),
                              np.asarray(T["maskv"](*c), np.float32) != 0)


@pytest.mark.parametrize("ne,m,N", [(4, 2, 4), (6, 3, 18), (8, 4, 8),
                                    (8, 4, 3)])
def test_torch_shard_fix_lanes_are_jax_merge_lanes(ne, m, N):
    """Each shard's fix lanes (its vd columns, the lanes its sweep merges)
    are the lanes JAX's per-variant merge mask ``dmv`` sets in its chunks,
    and the chunk flags are the variants."""
    _, jp, plan = _plans(ne)
    T = j_band_tables(jp, m)
    cps, bl = 6 * m // N, T["bl"]
    for s in range(N):
        bt = _band_shard(plan, m, N, s, "cpu").band
        want = []
        for l, c in enumerate(range(s * cps, (s + 1) * cps)):
            fl = (c % m == 0, c % m == m - 1)
            assert bt.first_last[l] == fl
            assert int(bt.flags[l]) == fl[0] + 2 * fl[1]
            dm = T["dmv"](*fl)[0]
            want += [l * bl + t * 128 + i for n, t in enumerate(T["tiles"])
                     for i in range(min(128, bl - t * 128))
                     if dm[n * 128 + i]]
        assert bt.fix.fix_lanes.tolist() == want


def _shard_case(ne, m, N, k, seed):
    """A random field's band shards on a CPU LocalMesh: (mesh, plan, x_ext,
    rsp shards, BandTables, vd, mx) and the JAX tables."""
    _, jp, plan = _plans(ne)
    mesh = LocalMesh(N, "cpu")
    rng = np.random.default_rng(seed)
    e16 = 6 * ne * ne * 16
    x = torch.from_numpy(rng.standard_normal((k, e16)).astype(np.float32))
    rsp = torch.from_numpy(rng.uniform(0.5, 1.5, (1, e16)).astype(np.float32))
    xe = band_extend(mesh, plan, m, shard_packed_t4(mesh, x)[0])
    bts = [_band_shard(plan, m, N, s, "cpu").band for s in range(N)]
    vds = [torch.from_numpy(rng.standard_normal((k, bt.fix.nfix)).astype(
        np.float32)) for bt in bts]
    return dict(xe=xe, rsp=shard_packed_t4(mesh, rsp)[0], bts=bts, vds=vds,
                T=j_band_tables(jp, m))


@pytest.mark.parametrize("ne,m,N", [(4, 2, 4), (8, 4, 3)])
def test_torch_banded_wrappers_match_pallas_on_shards(ne, m, N):
    """The wrappers in the port's operand form (x_ext from ``band_extend``,
    one vd column a fix lane, the chunk flags) against JAX's kernels fed the
    same values in its tile-dense form, on every shard: the merged sweep,
    the merge-free sweep and the patch, bit for bit; no launch counted on
    the CPU."""
    k = 2 * NLEV
    d = _shard_case(ne, m, N, k, seed=ne * N)
    T = d["T"]
    counts = [w.launches for w in WRAPPERS]
    for x_ext, r, bt, vd in zip(d["xe"], d["rsp"], d["bts"], d["vds"]):
        cps, wd = bt.nchunks, T["wd"]
        masks = jnp.concatenate([T["maskv"](*c) for c in bt.first_last], 1)
        dm = np.concatenate([T["dmv"](*c) for c in bt.first_last], axis=1)
        # tile-dense vals: each merged lane's column carries its vd value
        vals = np.zeros((k, cps * wd), np.float32)
        lanes = bt.fix.fix_lanes.numpy()
        c, loc = lanes // bt.bl, lanes % bt.bl
        pos = {t: n for n, t in enumerate(T["tiles"])}
        cols = c * wd + np.asarray([pos[l // 128] for l in loc]) * 128 \
            + loc % 128
        vals[:, cols] = vd.numpy()
        kw = dict(nchunks=cps, bl=bt.bl, rl=bt.rl, interpret=True)
        want = dss_sweeps_banded_t(x_ext.numpy(), r.numpy(), vals, dm, masks,
                                   T["tiles"], **kw)
        assert np.array_equal(dss_sweep_banded_cuda(x_ext, r, vd, bt), want)
        w0 = dss_sweeps_banded_nomerge(x_ext.numpy(), r.numpy(), masks, **kw)
        got = dss_sweep_banded_nomerge_cuda(x_ext, r, bt)
        assert np.array_equal(got, w0)
        assert np.array_equal(dss_patch_tiles_cuda(got, vd, bt.fix), want)
    assert [w.launches for w in WRAPPERS] == counts


# -- the steps ---------------------------------------------------------------

def _problem(ne, seed):
    """A packed f32 problem for both packages at ne: random state with the
    n0 and nm1 levels projected, random accumulators and pecnd, the
    two-float rspheremp."""
    jcs, jp, plan = _plans(ne)
    cfg = jt.Config(nelem=jcs.nelem, nlev=NLEV, elem_block=8)
    cast = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     tree)
    st = cast(jt.random_state(cfg, seed=seed))
    g = cast(jcs.geometry)
    gdof = jnp.asarray(jcs.gdof)

    def proj(x):
        x = np.array(x)
        for lev in (cfg.n0, cfg.nm1):
            x[lev] = np.asarray(j_dss_project(
                jnp.asarray(x[lev]), gdof, jcs.ndof, g.spheremp,
                g.rspheremp), np.float32)
        return x

    st = dataclasses.replace(st, u=proj(st.u), v=proj(st.v), t=proj(st.t),
                             dp3d=proj(st.dp3d))
    dv = cast(jt.zero_derived(cfg))
    rng = np.random.default_rng(seed + 1)
    dv = dataclasses.replace(dv, **{
        n: rng.uniform(-1, 1, dv.vn0_u.shape).astype(np.float32)
        for n in ("vn0_u", "vn0_v", "omega_p", "pecnd")})
    hv = jt.analytic_hvcoord(cfg).astype(np.float32)
    p = j_pack(st, dv, g, hv, cfg)
    cat = lambda keys: np.concatenate([np.asarray(p[key]) for key in keys])
    s0, sm1 = cat(("u0", "v0", "t0", "dp0")), cat(("um1", "vm1", "tm1",
                                                    "dpm1"))
    scal = np.asarray(j_scalars(np.float32(DT), np.float32(1.0), hv))
    acc = tuple(np.asarray(p[key]) for key in ("vn0u", "vn0v", "omg"))
    consts = tuple(p[key] for key in ("dxbt", "dybt", "ainct", "astrt",
                                      "bstrt", "meta"))
    rsp = np.ascontiguousarray(j_rsp_lanes_2f(
        np.asarray(g.spheremp, np.float32), jcs.gdof, jcs.ndof))
    return dict(
        j=(scal, consts, s0, sm1, np.asarray(p["qdp"]),
           np.asarray(p["pecnd"]), acc),
        t=(_T(scal), _T(p["meta"]), _T(s0), _T(sm1), _T(p["qdp"]),
           _T(p["pecnd"]), tuple(_T(a) for a in acc),
           _T(np.asarray(g.dvv, np.float32))),
        jp=jp, plan=plan, rsp=rsp, jcs=jcs)


@pytest.fixture(scope="module")
def step_case():
    """JAX's band-sharded (ne 4, m 2, 4 shards) and face-sharded (3 shards)
    assembled steps, overlap off and on, on one problem."""
    pr = _problem(4, seed=41)
    scal, consts, s0, sm1, qdp, pecnd, acc = pr["j"]
    R = jnp.asarray(pr["rsp"])
    args = (scal, *consts, s0, sm1, qdp, pecnd, *acc, pr["jp"], R)
    bmesh = Mesh(np.asarray(jax.devices()[:4]), ("e",))
    fmesh = j_face_mesh(n=3)
    kw = dict(eb=8, nlev=NLEV, interpret=True)
    pr["ref"] = {}
    for overlap in (False, True):
        with bmesh:
            pr["ref"]["banded", overlap] = j_banded(*args, bmesh, 2,
                                                    overlap=overlap, **kw)
        with fmesh:
            pr["ref"]["face", overlap] = j_sharded(*args, fmesh,
                                                   overlap=overlap, **kw)
    return pr


def _shard_args(mesh, tensors, rsp):
    scal, meta, s0, sm1, qdp, pecnd, acc, dvv = tensors
    sh = shard_packed_t4(mesh, meta, s0, sm1, qdp, pecnd, *acc, _T(rsp))
    return (scal, *sh[:8], dvv), sh[8]


def _single(pr):
    scal, meta, s0, sm1, qdp, pecnd, acc, dvv = pr["t"]
    return caar_dss_structured_packed_t4(scal, meta, s0, sm1, qdp, pecnd,
                                         *(a.clone() for a in acc), dvv,
                                         pr["plan"], _T(pr["rsp"]))


def _fields(got, ref):
    names = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg")
    pairs = list(zip(got[0].split(NLEV), np.split(np.asarray(ref[0]), 4)))
    pairs += list(zip(got[1:], ref[1:]))
    return {n: _err(a, b) for n, (a, b) in zip(names, pairs)}


@pytest.mark.parametrize("path,overlap", [("banded", False), ("banded", True),
                                          ("face", False), ("face", True)])
def test_torch_multidevice_step_matches_jax(step_case, path, overlap):
    """``caar_dss_banded_t4`` (ne 4, m 2, LocalMesh(4)) and
    ``caar_dss_sharded_t4`` (LocalMesh(3)), overlap off and on, against
    JAX's on its CPU mesh at 3e-6 per field; bit for bit the port's
    single-device step and the plain twin; continuity 0; accumulators in
    place."""
    pr = step_case
    mesh = LocalMesh(4 if path == "banded" else 3, "cpu")
    args, rsp = _shard_args(mesh, pr["t"], pr["rsp"])
    extra = (mesh, 2) if path == "banded" else (mesh,)
    step, plain = ((caar_dss_banded_t4, caar_dss_banded_t4_plain)
                   if path == "banded" else
                   (caar_dss_sharded_t4, caar_dss_sharded_t4_plain))
    kacc = [[a.clone() for a in x] for x in args[6:9]]
    got = step(*args[:6], *kacc, args[9], pr["plan"], rsp, *extra,
               overlap=overlap)
    assert all(g is a for gs, ks in zip(got[2:], kacc)
               for g, a in zip(gs, ks))
    got = [unshard_packed_t4(mesh, g) for g in got]
    errs = _fields(got, pr["ref"][path, overlap])
    assert max(errs.values()) < ASSEMBLED_TOL, errs
    twin = plain(*args, pr["plan"], rsp, *extra, overlap=overlap)
    for a, b, c in zip(got, _single(pr), twin):
        assert torch.equal(a, b) and torch.equal(a, unshard_packed_t4(mesh, c))
    assert continuity_error_t(got[0], pr["jcs"].gdof) == 0.0


@pytest.mark.parametrize("ne,m,N", [(4, 2, 2), (4, 2, 12), (6, 3, 18),
                                    (8, 4, 8), (8, 4, 3), (8, 2, 6)])
def test_torch_banded_step_equals_single_device(ne, m, N):
    """The banded step at every decomposition shape (one chunk a shard,
    several, a middle band with m >= 3), overlap off and on, bit for bit
    the single-device step; continuity 0."""
    pr = _problem(ne, seed=ne + N)
    want = _single(pr)
    mesh = LocalMesh(N, "cpu")
    args, rsp = _shard_args(mesh, pr["t"], pr["rsp"])
    for overlap in (False, True):
        got = caar_dss_banded_t4(*args[:6], *[[a.clone() for a in x]
                                              for x in args[6:9]],
                                 args[9], pr["plan"], rsp, mesh, m,
                                 overlap=overlap)
        for a, b in zip(got, want):
            assert torch.equal(unshard_packed_t4(mesh, a), b)
    assert continuity_error_t(want[0], pr["jcs"].gdof) == 0.0


@pytest.mark.parametrize("ne,N", [(4, 6), (4, 2), (3, 3)])
def test_torch_face_step_equals_single_device(ne, N):
    """The face-sharded step on 6, 2 and 3 shards (one face a shard, three,
    two; at ne 3 a face is 144 lanes, which JAX's 128-lane tiles refuse to
    share a shard), overlap off and on, bit for bit the single-device
    step."""
    pr = _problem(ne, seed=50 + N)
    want = _single(pr)
    mesh = make_face_mesh(N, "cpu")
    args, rsp = _shard_args(mesh, pr["t"], pr["rsp"])
    for overlap in (False, True):
        got = caar_dss_sharded_t4(*args[:6], *[[a.clone() for a in x]
                                               for x in args[6:9]],
                                  args[9], pr["plan"], rsp, mesh,
                                  overlap=overlap)
        for a, b in zip(got, want):
            assert torch.equal(unshard_packed_t4(mesh, a), b)


def test_torch_dss_banded_matches_jax():
    """The standalone banded DSS (extract, collectives, fixup, sweep) of a
    random field against JAX's ``dss_banded_t`` (single-f32 rspheremp: bit
    for bit) and the port's single-device structured DSS; overlap and the
    plain twin the same bits; continuity 0."""
    jcs, jp, plan = _plans(4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2 * NLEV, jcs.nelem * 16)).astype(np.float32)
    rsp = np.asarray(jcs.geometry.rspheremp, np.float32).reshape(1, -1)
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("e",))
    with jmesh:
        want = np.asarray(j_dss_banded(x, jp, jnp.asarray(rsp), jmesh, 2,
                                       interpret=True))
    mesh = LocalMesh(4, "cpu")
    xs, rs = shard_packed_t4(mesh, _T(x), _T(rsp))
    got = unshard_packed_t4(mesh, dss_banded_t(xs, plan, rs, mesh, 2))
    assert np.array_equal(got.numpy(), want)
    single = dss_structured_t(_T(x), plan) * _T(rsp)
    assert _err(got, single) < SWEEP_TOL
    for fn, overlap in ((dss_banded_t, True), (dss_banded_t_plain, False)):
        assert torch.equal(unshard_packed_t4(mesh, fn(xs, plan, rs, mesh, 2,
                                                      overlap=overlap)), got)
    assert continuity_error_t(got, jcs.gdof) == 0.0


# -- refusals and operand checks ---------------------------------------------

@pytest.mark.parametrize("ne,m,N,what", [
    (4, 1, 6, "m >= 2"), (6, 4, 6, "dividing"), (4, 2, 8, "N \\| 6m"),
    (6, 3, 6, "128"),
])
def test_torch_banded_refuses_what_jax_refuses(ne, m, N, what):
    """The JAX package's decompositions only: m >= 2 dividing ne, N | 6m,
    and 128 | bl when a shard holds several chunks."""
    pr = _problem(ne, seed=1)
    mesh = LocalMesh(N, "cpu")
    args, rsp = _shard_args(mesh, pr["t"], pr["rsp"])
    with pytest.raises(ValueError, match=what):
        caar_dss_banded_t4(*args, pr["plan"], rsp, mesh, m)


def test_torch_face_mesh_refuses_non_divisors():
    with pytest.raises(ValueError, match="n | 6"):
        make_face_mesh(4, "cpu")


@pytest.mark.parametrize("case", [
    "x_ext width", "vd shape", "rsp rows", "mix width", "flags dtype",
    "int tables", "in-place overlap", "patch w width", "patch overlap",
    "patch vd rows",
])
def test_torch_banded_wrappers_reject_bad_operands(case):
    d = _shard_case(4, 2, 4, NLEV, seed=2)
    x_ext, r, bt, vd = d["xe"][0], d["rsp"][0], d["bts"][0], d["vds"][0]
    lanes = bt.nchunks * bt.bl
    with pytest.raises(ValueError):
        if case == "x_ext width":
            dss_sweep_banded_cuda(x_ext[:, 1:].contiguous(), r, vd, bt)
        elif case == "vd shape":
            dss_sweep_banded_cuda(x_ext, r, vd[:, 1:].contiguous(), bt)
        elif case == "rsp rows":
            dss_sweep_banded_nomerge_cuda(x_ext, torch.cat([r, r, r]), bt)
        elif case == "mix width":
            dss_sweep_banded_cuda(x_ext, r, vd, bt,
                                  (torch.zeros(NLEV, lanes + 1), 1.0, 1.0))
        elif case == "flags dtype":
            bad = dataclasses.replace(bt, flags=bt.flags.long())
            dss_sweep_banded_cuda(x_ext, r, vd, bad)
        elif case == "int tables":
            bad = dataclasses.replace(bt, fix=dataclasses.replace(
                bt.fix, fix_col=bt.fix.fix_col.long()))
            dss_sweep_banded_cuda(x_ext, r, vd, bad)
        elif case == "in-place overlap":
            buf = torch.zeros(NLEV * x_ext.numel())
            xo = buf[:x_ext.numel()].view(x_ext.shape)
            xo.copy_(x_ext)
            mx = buf[:(NLEV + 1) * lanes].view(NLEV + 1, lanes)
            dss_sweep_banded_cuda(xo, r, vd, bt, (mx, 1.0, 1.0))
        elif case == "patch w width":
            dss_patch_tiles_cuda(torch.zeros(NLEV, lanes + 1), vd, bt.fix)
        elif case == "patch overlap":
            w = torch.zeros(NLEV, lanes)
            dss_patch_tiles_cuda(w, w[:, :bt.fix.nfix].contiguous(), bt.fix,
                                 (w, 1.0, 1.0))
        else:
            dss_patch_tiles_cuda(torch.zeros(NLEV - 1, lanes), vd, bt.fix)
