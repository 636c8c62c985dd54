"""The remap kernel's algorithm (``csrc/remap.cu``) on the CPU, through its
torch emulation in ``kernels/remap.py`` (the kernel itself runs only on the
card, where ``chip_smoke.py`` phase 21 holds it to the plain code), and the
dispatch and the refusals of the remap wrappers.

Tolerances: 1e-12 scaled for the float64 walk against JAX's ``remap_column``
and for the float64 packed emulation against JAX's packed remap (the JAX
form takes differences of prefix integrals, which lose ~K ulps; with thin
target layers the masses are compared, since a thin layer's mean from
prefix differences loses eps * column / layer);
the float32 packed emulation's dp rows bit for bit the plain code's (the
same rounded operations in the same order); its fields within 1e-6 scaled
of JAX's packed remap in float64 on the same inputs (measured ~2e-7: the
remap onto the float64 target layers, f32 pieces), also at E3SM's 35
tracers; column totals within 1e-6 of the column's sum |x|*dp (the pieces
of a source cell sum to its mass); PCM and PLM stay inside the source
column's range within 1e-12 of it; the kernel's geometry (cells and
fractions) bit for bit the walk of the kernel's design before. The fixer's
fold (its two launches emulated, and the wrapper's sequence of launches
with the library stubbed) bit for bit the kernel followed by the plain
fixer: the same rounded values, each scaled by one rounded product.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu.dist.step_pallas import (
    remap_packed_t4 as j_remap_packed)
from tinman_sandbox_tpu.grid import HybridVCoord as JHybridVCoord
from tinman_sandbox_tpu.ops.remap import remap_column as j_remap_column
from tinman_sandbox_tpu_torch.device import from_arrays
from tinman_sandbox_tpu_torch.dist import (packed_air_mass, remap_packed_t4,
                                           remap_packed_t4_plain)
from tinman_sandbox_tpu_torch.dist.step_t import _fix_mass
from tinman_sandbox_tpu_torch.grid import HybridVCoord
from tinman_sandbox_tpu_torch.kernels import _build, remap
from tinman_sandbox_tpu_torch.kernels.remap import (
    FIX_DP, FIX_SCALE, SCHEMES, _geometry, remap_levels_cuda,
    remap_packed_cuda, remap_packed_emulated, remap_packed_plain, remap_plan,
    remap_walk_emulated)
from tinman_sandbox_tpu_torch.profiling import record_spans
from tinman_sandbox_tpu_torch.ops.remap import remap_levels, remap_levels_plain

torch.set_num_threads(2)
F64_TOL = 1e-12
F32_TOL = 1e-6
TOTAL_TOL = 1e-6
NCOL = 48


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _equal_totals(rng, dp_src, w):
    """Target layers of weights w with dp_src's column totals."""
    return w / w.sum(0) * dp_src.sum(0)


def _case(name, rng):
    """(q, dp_src, dp_tgt) [K, NCOL] in float64 for one edge case."""
    k = {"nlev1": 1, "nlev2": 2, "nlev3": 3}.get(name, 12)
    dp_src = rng.uniform(5.0, 15.0, (k, NCOL))
    q = rng.normal(size=(k, NCOL)) * 20.0 + 250.0
    if name == "identical":
        return q, dp_src, dp_src.copy()
    if name == "coincide":
        # t_1 = s_2 exactly; t_3 = s_3 up to the rounding of two halves;
        # from there on every interface is a source one
        dp_tgt = np.concatenate([dp_src[:1] + dp_src[1:2], dp_src[2:3] / 2,
                                 dp_src[2:3] / 2, dp_src[3:]])
        return q, dp_src, dp_tgt
    dp_tgt = _equal_totals(rng, dp_src, rng.uniform(0.5, 1.5, (k, NCOL)))
    if name in ("below", "above"):
        # the target column ends a few ulps short of / past the source's
        dp_tgt *= 1.0 + (-4.0 if name == "below" else 4.0) \
            * np.finfo(np.float64).eps
    elif name == "thin":
        dp_src[3::4] *= 1e-7
        dp_tgt[1::5] *= 1e-7
        dp_tgt = _equal_totals(rng, dp_src, dp_tgt)
    return q, dp_src, dp_tgt


CASES = ("random", "identical", "coincide", "below", "above", "thin",
         "nlev1", "nlev2", "nlev3")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", CASES)
def test_torch_remap_walk_matches_jax_f64(case, scheme):
    """The kernel's merge walk (direct sums of the overlapped pieces) equals
    JAX's dense prefix-integral remap in float64."""
    rng = np.random.default_rng(CASES.index(case))
    q, dp_src, dp_tgt = _case(case, rng)
    k = q.shape[0]
    cols = lambda x: jnp.asarray(x.T.reshape(-1, 4, 4, k).transpose(0, 3, 1,
                                                                      2))
    want = np.asarray(j_remap_column(cols(q), cols(dp_src), cols(dp_tgt),
                                     scheme=scheme))
    want = want.transpose(0, 2, 3, 1).reshape(-1, k).T
    got = remap_walk_emulated(*(torch.from_numpy(x) for x in
                                (q, dp_src, dp_tgt)), scheme).numpy()
    if case == "thin":
        # a thin target layer's mean from JAX's prefix differences carries
        # eps * (column / layer) ~ 1e-8: compare the layers' masses
        got, want = got * dp_tgt, want * dp_tgt
    assert _scaled(got, want) < F64_TOL
    if case == "identical":
        assert _scaled(got, q) < F64_TOL


def _packed(nlev=12, qsize=2, seed=3, ncol=64):
    """A Lagrangian packed column set in float32 with physically monotone
    hybrid levels (hyai = 0.12(1 - eta), hybi = eta, the packed cadence
    example's): s [4*nlev, ncol], qdp [qsize*nlev, ncol], hv arrays."""
    rng = np.random.default_rng(seed)
    eta = np.linspace(0.0, 1.0, nlev + 1, dtype=np.float32)
    hyai = (np.float32(0.12) * (np.float32(1.0) - eta)).astype(np.float32)
    hv = dict(ps0=1000.0, hyai=hyai, hybi=eta,
              hyam=np.float32(0.5) * (hyai[:-1] + hyai[1:]),
              hybm=np.float32(0.5) * (eta[:-1] + eta[1:]))
    dp = rng.uniform(0.5, 1.5, (nlev, ncol)) * 1000.0 / nlev
    uvt = rng.normal(size=(3 * nlev, ncol))
    uvt[2 * nlev:] += 280.0
    qdp = rng.uniform(0.0, 0.01, (qsize * nlev, ncol)) * np.tile(dp,
                                                                 (qsize, 1))
    s = np.concatenate([uvt, dp]).astype(np.float32)
    return s, qdp.astype(np.float32), hv


def _thv(hv, dtype=None):
    return from_arrays(HybridVCoord, hv, dtype=dtype, device="cpu")


@pytest.mark.parametrize("nlev", [1, 6, 72])
def test_torch_remap_packed_emulated_dp_rows_are_plain_bits(nlev):
    """The kernel's dp rows (the compensated totals, ps, dp_ref and the
    ratio in the plain code's order) are the plain packed remap's bits, and
    so are the fixer's scaled rows after them."""
    s, qdp, hv = _packed(nlev=nlev)
    s, qdp = torch.from_numpy(s), torch.from_numpy(qdp)
    emu = remap_packed_emulated(s, qdp, _thv(hv), nlev, 2)
    plain = remap_packed_t4_plain(s, qdp, _thv(hv), 4, nlev, 2)
    assert torch.equal(emu[0][3 * nlev:], plain[0][3 * nlev:])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_remap_packed_emulated_matches_jax_f64(scheme):
    """The float32 emulation against JAX's packed remap in float64 on the
    same inputs (hv in float32, as the packed cadence has it), every block
    but the dp rows, which are the float32 plain code's."""
    nlev = 12
    s, qdp, hv = _packed(nlev=nlev)
    js, jq = j_remap_packed(jnp.asarray(s, jnp.float64),
                            jnp.asarray(qdp, jnp.float64),
                            JHybridVCoord(**hv), nelem=4, nlev=nlev,
                            qsize=2, scheme=scheme)
    es, eq = remap_packed_emulated(torch.from_numpy(s), torch.from_numpy(qdp),
                                   _thv(hv), nlev, 2, scheme)
    js, jq = np.asarray(js), np.asarray(jq)
    for i in range(3):
        blk = slice(i * nlev, (i + 1) * nlev)
        assert _scaled(es[blk], js[blk]) < F32_TOL, i
    for i in range(2):
        blk = slice(i * nlev, (i + 1) * nlev)
        assert _scaled(eq[blk], jq[blk]) < F32_TOL, i


@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_remap_packed_emulated_keeps_column_totals(scheme):
    """Every column's total of x*dp (u, v, T) and of qdp survives the
    float32 walk within 1e-6 of the column's sum |x|*dp."""
    nlev = 72
    s, qdp, hv = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                  for x in _packed(nlev=nlev, seed=5))
    es, eq = remap_packed_emulated(s, qdp, _thv(hv), nlev, 2, scheme)
    dp, dpt = s[3 * nlev:].double(), es[3 * nlev:].double()
    for x, y in zip(s[:3 * nlev].split(nlev), es[:3 * nlev].split(nlev)):
        x, y = x.double(), y.double()
        err = ((y * dpt).sum(0) - (x * dp).sum(0)).abs() \
            / (x.abs() * dp).sum(0)
        assert float(err.max()) < TOTAL_TOL
    for x, y in zip(qdp.split(nlev), eq.split(nlev)):
        x, y = x.double(), y.double()
        assert float(((y.sum(0) - x.sum(0)).abs() / x.abs().sum(0)).max()) \
            < TOTAL_TOL


@pytest.mark.parametrize("scheme", ["pcm", "plm"])
def test_torch_remap_walk_stays_in_the_source_range(scheme):
    """PCM and PLM (minmod) are monotone: every remapped value lies inside
    its source column's range."""
    rng = np.random.default_rng(9)
    q, dp_src, dp_tgt = _case("random", rng)
    got = remap_walk_emulated(*(torch.from_numpy(x) for x in
                                (q, dp_src, dp_tgt)), scheme).numpy()
    span = q.max(0) - q.min(0)
    assert np.all(got <= q.max(0) + F64_TOL * span)
    assert np.all(got >= q.min(0) - F64_TOL * span)


def test_torch_remap_dispatch_on_cpu_is_the_plain_code():
    """CPU tensors take today's plain code, bit for bit, through every
    entry point."""
    nlev = 6
    s, qdp, hv = _packed(nlev=nlev)
    s, qdp = torch.from_numpy(s), torch.from_numpy(qdp)
    dp = s[3 * nlev:]
    dpt = remap_packed_plain(s, qdp, _thv(hv), nlev, 2)[0][3 * nlev:]
    for scheme in SCHEMES:
        want = remap_levels_plain(s[:nlev], dp, dpt, scheme)
        assert torch.equal(remap_levels(s[:nlev], dp, dpt, scheme), want)
        three = remap_levels_cuda(s[:3 * nlev], dp, dpt, scheme)
        assert torch.equal(three[:nlev], want)
        a = remap_packed_t4(s, qdp, _thv(hv), 4, nlev, 2, scheme)
        b = remap_packed_t4_plain(s, qdp, _thv(hv), 4, nlev, 2, scheme)
        c = remap_packed_cuda(s, qdp, _thv(hv), nlev, 2, scheme)
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(x, z)


def _fixer_operands(s, nlev, seed=4):
    """The fixer's spheremp lanes [1, C] (positive) and a target 0.1% above
    the air mass of s, in s's dtype."""
    rng = np.random.default_rng(seed)
    sph = torch.from_numpy(rng.uniform(0.5, 1.5, (1, s.shape[1]))).to(s.dtype)
    return sph, packed_air_mass(s, sph, nlev) * 1.001


def _bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("qsize", [1, 2])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_remap_packed_emulated_fixer_is_kernel_then_fix_mass(
        dtype, scheme, qsize):
    """The fixer's fold, emulated: the dp-only launch gives the packed
    kernel's dp rows bit for bit; their air mass, then the scaled launch
    (r = target / mass, every dp row and tracer value times r), gives the
    kernel's outputs followed by ``_fix_mass`` bit for bit, u, v, T
    untouched."""
    nlev = 12
    s, qdp, hv = _packed(nlev=nlev, qsize=qsize, seed=6)
    s, qdp = torch.from_numpy(s).to(dtype), torch.from_numpy(qdp).to(dtype)
    thv = _thv({n: np.asarray(v, np.float64 if dtype == torch.float64
                              else np.float32) for n, v in hv.items()},
               dtype)
    sph, target = _fixer_operands(s, nlev)
    base = remap_packed_emulated(s, qdp, thv, nlev, qsize, scheme)
    dp = remap_packed_emulated(s, qdp, thv, nlev, qsize, scheme,
                               dp_only=True)
    assert torch.equal(_bits(dp), _bits(base[0][3 * nlev:]))
    s_a = torch.zeros_like(s)       # launch (a) writes only the dp rows
    s_a[3 * nlev:] = dp
    mass = packed_air_mass(s_a, sph, nlev)
    got = remap_packed_emulated(s, qdp, thv, nlev, qsize, scheme, mass=mass,
                                target=target)
    want = _fix_mass(base[0].clone(), base[1].clone(), nlev, sph, target)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert torch.equal(got[0][:3 * nlev], base[0][:3 * nlev])
    assert not torch.equal(got[1], base[1])     # the fixer did scale


@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_remap_fixer_dispatch_on_cpu_is_plain_then_fix_mass(scheme):
    """CPU tensors with the fixer's operands: the wrapper runs the plain
    remap and then the plain fixer, the bits of ``remap_packed_t4_plain``
    (and of ``remap_packed_t4``) with the fixer."""
    nlev = 6
    s, qdp, hv = _packed(nlev=nlev)
    s, qdp = torch.from_numpy(s), torch.from_numpy(qdp)
    sph, target = _fixer_operands(s, nlev)
    got = remap_packed_cuda(s, qdp, _thv(hv), nlev, 2, scheme, sph, target)
    plain = remap_packed_t4_plain(s, qdp, _thv(hv), 4, nlev, 2, scheme, sph,
                                  target)
    user = remap_packed_t4(s, qdp, _thv(hv), 4, nlev, 2, scheme, sph, target)
    free = remap_packed_plain(s, qdp, _thv(hv), nlev, 2, scheme)
    for g, p, u, f in zip(got, plain, user, free):
        assert torch.equal(g, p) and torch.equal(g, u)
        assert not torch.equal(g[-nlev:], f[-nlev:])


class _StubLibrary:
    """The remap library with its launches recorded, not run."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.mark.parametrize("case", ["f32", "f64", "f32 fixer", "f64 fixer"])
def test_torch_remap_cuda_branch_launches(case, monkeypatch):
    """The wrapper's CUDA branch (reached by checks that report a card, the
    library stubbed): without the fixer one launch of the packed kernel;
    with it the dp-only launch, the air mass of its output inside the
    ``remap.fixer`` span, then the scaled launch with that mass's and the
    target's pointers, on the same outputs; the counters follow."""
    nlev, qsize = 6, 2
    dtype = torch.float64 if "f64" in case else torch.float32
    s, qdp, hv = _packed(nlev=nlev, qsize=qsize)
    s, qdp = torch.from_numpy(s).to(dtype), torch.from_numpy(qdp).to(dtype)
    thv = _thv(hv, dtype)
    fixer = _fixer_operands(s, nlev) if "fixer" in case else (None, None)
    lib = _StubLibrary()
    masses = []
    air_mass = remap.packed_air_mass
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "check_launch", lambda name, err: None)
    monkeypatch.setattr(remap, "_check", lambda *a, **kw: torch.device(
        "cuda", 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        types.SimpleNamespace(cuda_stream=7)))
    monkeypatch.setattr(remap, "packed_air_mass", lambda *a: masses.append(
        air_mass(*a)) or masses[-1])
    before = (remap_packed_cuda.launches, remap_packed_cuda.f64_launches,
              remap_packed_cuda.fixer_launches)
    with record_spans() as rec:
        s_out, q_out = remap_packed_cuda(s, qdp, thv, nlev, qsize, "ppm",
                                         *fixer)
    n = 2 if "fixer" in case else 1
    assert (remap_packed_cuda.launches - before[0],
            remap_packed_cuda.f64_launches - before[1],
            remap_packed_cuda.fixer_launches - before[2]) == (
        n, n if dtype == torch.float64 else 0, n - 1)
    common = (int(dtype == torch.float64), SCHEMES.index("ppm"))
    ptrs = (s.data_ptr(), qdp.data_ptr(), thv.hyai.data_ptr(),
            thv.hybi.data_ptr(), float(thv.ps0), s_out.data_ptr(),
            q_out.data_ptr())
    tail = (nlev, qsize, s.shape[1], 7, 0)
    names = [r.name for r in rec.records]
    if n == 1:
        assert lib.calls == [("remap_packed_launch", common + ptrs + tail)]
        assert "remap.fixer" not in names and not masses
        return
    assert lib.calls == [
        ("remap_fixer_launch", common + (FIX_DP,) + ptrs + (None, None)
         + tail),
        ("remap_fixer_launch", common + (FIX_SCALE,) + ptrs
         + (masses[0].data_ptr(), fixer[1].data_ptr()) + tail)]
    # the air mass of launch (a)'s output, inside the wrapper's span
    fixer_span = names.index("remap.fixer")
    assert rec.records[rec.records[fixer_span].parent].name == \
        "launch.remap_packed_cuda"
    assert len(masses) == 1 and masses[0].shape == ()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_remap_packed_emulated_f64_matches_jax(scheme):
    """The float64 emulation against JAX's packed remap in float64 on the
    same inputs (hv in float64 on both sides), every block, dp rows
    included, at 1e-12."""
    nlev = 12
    s, qdp, hv = _packed(nlev=nlev)
    s, qdp = s.astype(np.float64), qdp.astype(np.float64)
    hv = {n: np.asarray(v, np.float64) for n, v in hv.items()}
    js, jq = j_remap_packed(jnp.asarray(s), jnp.asarray(qdp),
                            JHybridVCoord(**hv), nelem=4, nlev=nlev,
                            qsize=2, scheme=scheme)
    es, eq = remap_packed_emulated(torch.from_numpy(s), torch.from_numpy(qdp),
                                   _thv(hv, torch.float64), nlev, 2, scheme)
    for got, want in zip((es, eq), (js, jq)):
        for g, w in zip(got.split(nlev), np.split(np.asarray(want),
                                                  got.shape[0] // nlev)):
            assert _scaled(g, w) < F64_TOL


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_torch_remap_packed_emulated_qsize35(dtype):
    """E3SM's 35 tracers at a CPU size (ne2 x 8): the emulation against
    JAX's packed remap in float64 (float32 at 1e-6 scaled, float64 at
    1e-12), and every tracer's column mass kept within 1e-6."""
    nlev, qsize, ncol = 8, 35, 24 * 16
    s, qdp, hv = _packed(nlev=nlev, qsize=qsize, seed=8, ncol=ncol)
    tol = F32_TOL if dtype == "float32" else F64_TOL
    s, qdp = s.astype(dtype), qdp.astype(dtype)
    if dtype == "float64":   # hv in float64 on both sides
        hv = {n: np.asarray(v, np.float64) for n, v in hv.items()}
    js, jq = j_remap_packed(jnp.asarray(s, jnp.float64),
                            jnp.asarray(qdp, jnp.float64),
                            JHybridVCoord(**hv), nelem=24, nlev=nlev,
                            qsize=qsize, scheme="plm")
    tdt = torch.float32 if dtype == "float32" else torch.float64
    es, eq = remap_packed_emulated(torch.from_numpy(s), torch.from_numpy(qdp),
                                   _thv(hv, tdt), nlev, qsize, "plm")
    js, jq = np.asarray(js), np.asarray(jq)
    for i in range(3):
        blk = slice(i * nlev, (i + 1) * nlev)
        assert _scaled(es[blk], js[blk]) < tol, i
    for i in range(qsize):
        blk = slice(i * nlev, (i + 1) * nlev)
        assert _scaled(eq[blk], jq[blk]) < tol, i
        x, y = torch.from_numpy(qdp[blk]).double(), eq[blk].double()
        assert float(((y.sum(0) - x.sum(0)).abs() / x.abs().sum(0)).max()) \
            < TOTAL_TOL, i


def _old_walk(dp_src, dp_tgt):
    """The geometry pass of the kernel's design before its redesign for the
    H100, in plain Python on numpy columns [K, C]: 8 warps, each summing t
    and walking from the column's top for its segment of the interfaces,
    a = clip(t - s, 0, dp) rounded to dp_src's dtype at every step, a cell
    passed where a reaches dp. Returns (c [K+1, C], a [K+1, C])."""
    k, ncol = dp_src.shape
    typ = dp_src.dtype.type
    c = np.zeros((k + 1, ncol), np.int64)
    a = np.zeros((k + 1, ncol), dp_src.dtype)
    n = k - 1
    for col in range(ncol):
        for w in range(8):
            j_lo, j_hi = 1 + w * n // 8, 1 + (w + 1) * n // 8
            s = t = 0.0
            cell = 0
            for i in range(j_lo - 1):
                t += float(dp_tgt[i, col])
            for j in range(j_lo, j_hi):
                t += float(dp_tgt[j - 1, col])
                aj = typ(0)
                while cell < k:
                    d = dp_src[cell, col]
                    aj = typ(min(max(t - s, 0.0), float(d)))
                    if aj < d:
                        break
                    s += float(d)
                    cell += 1
                    aj = typ(0)
                c[j, col], a[j, col] = cell, aj
        c[k, col] = k
    return c, a


def _ulp_case(dtype, rng):
    """Columns whose first target interface lies on, or an ulp beside, the
    first source cell's end and, in float32, on the midpoint between that
    end and the float below it (odd and even last bits), or beside it."""
    k = 12
    dp_src = rng.uniform(5.0, 15.0, (k, NCOL)).astype(dtype)
    if dtype == np.float32:
        bits = dp_src[0].view(np.int32)
        bits[::2] |= 1
        bits[1::2] &= ~1
        below = (bits - 1).view(np.float32).astype(np.float64)
        mid = 0.5 * (below + dp_src[0].astype(np.float64))
    else:
        mid = dp_src[0].astype(np.float64)
    ends = [mid, np.nextafter(mid, -np.inf), np.nextafter(mid, np.inf),
            dp_src[0].astype(np.float64),
            dp_src[0].astype(np.float64) + dp_src[1].astype(np.float64),
            np.nextafter(dp_src[0].astype(np.float64), -np.inf)]
    first = np.choose(np.arange(NCOL) % len(ends), ends)
    rest = rng.uniform(0.5, 1.5, (k - 1, NCOL))
    total = dp_src.astype(np.float64).sum(0)
    rest = rest / rest.sum(0) * (total - first)
    return dp_src, np.concatenate([first[None], rest])


GEOMETRY_CASES = ("random", "identical", "coincide", "below", "above",
                  "thin", "ulp")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", GEOMETRY_CASES)
def test_torch_remap_geometry_is_the_old_walk(case, dtype):
    """The kernel's geometry (thresholds, four cells a step) gives the cells
    c_j and local coordinates a_j of the walk before its redesign bit for
    bit, xi_j = a_j / dp_c: on thin layers, interfaces that coincide,
    target columns a few ulps short or long, and target interfaces on a
    source interface or on a rounding midpoint to the last ulp."""
    rng = np.random.default_rng(31 + GEOMETRY_CASES.index(case))
    if case == "ulp":
        dp_src, dp_tgt = _ulp_case(dtype, rng)
    else:
        _, dp_src, dp_tgt = _case(case, rng)
        dp_src = dp_src.astype(dtype)
        if dtype == np.float32 and case in ("identical", "coincide"):
            dp_tgt = dp_src.astype(np.float64) if case == "identical" \
                else dp_tgt.astype(np.float32).astype(np.float64)
    c_old, a_old = _old_walk(dp_src, dp_tgt)
    c, xi = _geometry(torch.from_numpy(dp_src), torch.from_numpy(dp_tgt))
    assert np.array_equal(c.numpy(), c_old)
    k = dp_src.shape[0]
    d = np.take_along_axis(dp_src, np.minimum(c_old, k - 1), 0)
    want = np.where(c_old < k, a_old / d, 0).astype(dtype)
    assert np.array_equal(xi.numpy().view(np.uint8), want.view(np.uint8))


def _refusals():
    nlev = 6
    s, qdp, hv = _packed(nlev=nlev)
    s, qdp = torch.from_numpy(s), torch.from_numpy(qdp)
    dp = s[3 * nlev:]
    t = _thv(hv)
    sph, target = _fixer_operands(s, nlev)
    return {
        "levels q rows": lambda: remap_levels_cuda(s[:nlev + 1], dp, dp),
        "levels dp_tgt shape": lambda: remap_levels_cuda(s[:nlev], dp,
                                                         dp[:-1]),
        "levels scheme": lambda: remap_levels_cuda(s[:nlev], dp, dp, "weno"),
        "levels mixed dtype": lambda: remap_levels_cuda(
            s[:nlev], dp.double(), dp.double()),
        "levels not contiguous": lambda: remap_levels_cuda(
            s[:nlev].T.contiguous().T, dp, dp),
        "levels int": lambda: remap_levels_cuda(
            s[:nlev].int(), dp.int(), dp.int()),
        "packed s rows": lambda: remap_packed_cuda(s[:-1], qdp, t, nlev, 2),
        "packed qsize": lambda: remap_packed_cuda(s, qdp, t, nlev, 3),
        "packed scheme": lambda: remap_packed_cuda(s, qdp, t, nlev, 2, "x"),
        "packed hv dtype": lambda: remap_packed_cuda(
            s, qdp, _thv(hv, torch.float64), nlev, 2),
        "packed qdp dtype": lambda: remap_packed_cuda(s, qdp.double(), t,
                                                      nlev, 2),
        "packed t4 shape": lambda: remap_packed_t4(s, qdp, t, 5, nlev, 2),
        "fixer sph_lanes alone": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph),
        "fixer mass_target alone": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, mass_target=target),
        "fixer host target": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph, mass_target=float(target)),
        "fixer target shape": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph, mass_target=target[None]),
        "fixer target dtype": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph, mass_target=target.double()),
        "fixer target device": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph,
            mass_target=target.to("meta")),
        "fixer sph_lanes shape": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph[0], mass_target=target),
        "fixer sph_lanes dtype": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph.double(), mass_target=target),
        "fixer sph_lanes device": lambda: remap_packed_cuda(
            s, qdp, t, nlev, 2, sph_lanes=sph.to("meta"), mass_target=target),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_torch_remap_wrappers_refuse(name):
    """Every operand the kernel does not take is refused by the wrapper,
    on any device: a mixed-dtype call raises and is never cast."""
    with pytest.raises((ValueError, TypeError)):
        _refusals()[name]()


@pytest.mark.parametrize("nlev, itemsize, scheme, smem", [
    (72, 4, "plm", 42240), (72, 4, "pcm", 33024), (72, 8, "ppm", 98240),
    (326, 4, "ppm", 232304), (509, 4, "pcm", 232304), (210, 8, "plm", 232160),
    (170, 8, "ppm", 231520)])
def test_torch_remap_plan(nlev, itemsize, scheme, smem):
    """A block's shared memory (csrc/remap.cu's remap_smem_bytes): the
    block's 2*nlev hybrid terms to a 16-byte boundary (the column arrays
    take 16-byte copies), and for each of 32 columns dp_src, the field, the
    scheme's coefficient arrays of nlev values, the nlev + 1 interface
    fractions and the nlev + 1 cell indices. The level limits stay those of
    the design before: f32 plm 397, ppm 326, pcm 509; f64 plm 210, ppm
    170."""
    assert remap_plan(nlev, itemsize, scheme) == smem <= 232448


@pytest.mark.parametrize("nlev, itemsize, scheme", [
    (327, 4, "ppm"), (510, 4, "pcm"), (211, 8, "plm"), (171, 8, "ppm"),
    (0, 4, "plm")])
def test_torch_remap_plan_refuses(nlev, itemsize, scheme):
    with pytest.raises(ValueError, match="shared memory"):
        remap_plan(nlev, itemsize, scheme)
