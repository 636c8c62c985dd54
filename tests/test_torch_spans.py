"""The spans and counters of the port's cadence path
(``profiling.span``, ``record_spans``, ``launch_span``, ``limiter_counts``)
on the CPU: the span tree of a step and a remap with the fixer, the step
ids, parents and self times, nothing recorded while off, the same bits with
recording on and off, the plain limiter's counts on a crafted input, and
the limited stage's wrapper launching the counting twin only while counters
are on."""
import pytest
import torch

from tinman_sandbox_tpu_torch import profiling
from tinman_sandbox_tpu_torch.dist import (
    packed_air_mass, prim_step_packed_t4, prim_step_packed_t4_plain,
    remap_packed_t4_plain)
from tinman_sandbox_tpu_torch.examples.packed_cadence import (
    make_cadence_problem)
from tinman_sandbox_tpu_torch.kernels import tracer_t
from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
from tinman_sandbox_tpu_torch.kernels.tracer_t import (
    tracer_limit_cuda, tracer_limit_plain)
from tinman_sandbox_tpu_torch.profiling import record_spans

NLEV, QSIZE, DT, NU = 8, 2, 50.0, 1e15


@pytest.fixture(scope="module")
def prob():
    return make_cadence_problem(2, NLEV, QSIZE, DT, device="cpu")


def _steps(prob, n, step=prim_step_packed_t4_plain, qsplit=1, subcycle=1):
    """n prim steps, each followed by the remap with the fixer; returns
    every output of every step and remap."""
    p = prob
    s, qdp = p["s"], p["qdp"]
    acc = tuple(a.clone() for a in p["acc"])
    target = packed_air_mass(s, p["sph_lanes"], NLEV)
    outs = []
    for _ in range(n):
        s, qdp, phi, *acc = step(
            p["scal"], p["meta"], s, qdp, p["pecnd"], *acc, p["dvv"],
            p["plan"], p["rsp"], NU, NLEV, qsplit=qsplit, subcycle=subcycle,
            limit_tracers=True, dt=DT)
        s, qdp = remap_packed_t4_plain(s, qdp, p["hv"], p["cfg"].nelem, NLEV,
                                       QSIZE, sph_lanes=p["sph_lanes"],
                                       mass_target=target)
        outs += [s, qdp, phi, *acc]
    return outs


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


@pytest.mark.parametrize("qsplit,subcycle", [(1, 1), (2, 2)])
def test_torch_spans_tree_of_a_step(prob, qsplit, subcycle):
    with record_spans() as rec:
        _steps(prob, 2, qsplit=qsplit, subcycle=subcycle)
    recs = rec.records
    top = [(i, r) for i, r in enumerate(recs) if r.parent is None]
    assert [(r.name, r.step) for _, r in top] == [
        ("prim.step", 0), ("remap", 0), ("prim.step", 1), ("remap", 1)]
    for i, r in top:
        kids = _children(recs, i)
        if r.name == "remap":
            assert kids == ["remap.kernel", "remap.fixer"]
            continue
        assert kids == ["prim.dynamics", "prim.hypervis"] \
            + ["prim.tracers"] * qsplit
        for j, k in enumerate(recs):
            if k.parent != i:
                continue
            want = {"prim.dynamics": ["prim.dynamics.stage"] * 3,
                    "prim.hypervis": ["prim.hypervis.pass"] * 2 * subcycle,
                    "prim.tracers": ["prim.tracers.stage"] * 3}[k.name]
            assert _children(recs, j) == want
    # every span closed, inside its parent, with its step's id
    for r in recs:
        assert r.end_ns is not None and r.end_ns >= r.start_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert p.step == r.step
    stats = rec.stats()
    assert stats["prim.step"][0] == 2 and stats["remap.fixer"][0] == 2
    assert stats["prim.tracers.stage"][0] == 2 * 3 * qsplit
    assert stats["prim.hypervis.pass"][0] == 2 * 2 * subcycle
    for calls, total, own in stats.values():
        assert 0 <= own <= total
    # self time: the duration less the children's
    kids = sum(r.end_ns - r.start_ns for r in recs
               if r.parent is not None and recs[r.parent].name == "remap")
    remaps = sum(r.end_ns - r.start_ns for r in recs if r.name == "remap")
    assert stats["remap"][2] == remaps - kids


def test_torch_spans_launch_spans_under_their_stages(prob):
    """Through the wrappers (CPU tensors take their plain versions) each
    stage holds its producer's and closers' ``launch.<wrapper>`` spans."""
    with record_spans() as rec:
        _steps(prob, 1, step=prim_step_packed_t4)
    recs = rec.records
    kids = {}
    for i, r in enumerate(recs):
        if r.name.startswith(("prim.dynamics.", "prim.hypervis.",
                              "prim.tracers.")):
            kids.setdefault(r.name, set()).update(
                k.name for k in recs if k.parent == i)
    closers = {"launch.dss_fixup_cuda", "launch.dss_sweep_cuda"}
    assert kids == {
        "prim.dynamics.stage": {"launch.caar_t4_cuda"} | closers,
        "prim.hypervis.pass": {"launch.vlap_cuda"} | closers,
        "prim.tracers.stage": {"launch.tracer_limit_cuda"} | closers}


def test_torch_spans_off_records_nothing(prob):
    assert profiling.span("prim.step") is profiling.span("remap")
    assert profiling.limiter_counts("cpu") is None
    _steps(prob, 1)
    with record_spans() as rec:
        pass
    assert rec.records == [] and rec.stats() == {}
    assert profiling.span("prim.step") is profiling.span("remap")
    with record_spans():
        with pytest.raises(RuntimeError):
            with record_spans():
                pass


@pytest.mark.parametrize("profiler,counters", [(False, False), (True, True)])
def test_torch_spans_same_bits_on_and_off(prob, profiler, counters):
    off = _steps(prob, 2, step=prim_step_packed_t4)
    with record_spans(profiler=profiler, counters=counters) as rec:
        on = _steps(prob, 2, step=prim_step_packed_t4)
    assert len(rec.records) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    if counters:
        n = rec.limiter()
        # 2 steps x 3 stages x (QSIZE*NLEV rows x 3 warps of the 24
        # elements) x 2 passes, each computed or, with no deficit in the
        # warp, skipped
        assert n["warp_passes"] + n["warp_passes_skipped"] == \
            2 * 3 * QSIZE * NLEV * 3 * 2
        assert 0 < n["warp_passes_with_deficit"] == n["warp_passes"]
        assert n["warp_passes_skipped"] > 0
        assert n["warp_passes_with_deficit"] <= \
            n["element_passes_with_deficit"] <= 8 * n["warp_passes"]


def _crafted(fit, over, rows=3, nel=16):
    """A limited stage whose y is the mix field (dt 0, y = 1*mx + 0*e) and
    whose weights are 1: every element's stage input q has 15 lanes at 0
    and one at 1. An element in ``fit`` gets one lane at 1.5 in y, which
    the others' room takes in the first pass; one in ``over`` has every
    lane at 2, which no room takes, so its deficit is carried into the
    second pass. ``fit``, ``over``: sets of (row, element)."""
    e16 = nel * 16
    meta = torch.zeros(len(META_COLS), e16, dtype=torch.float64)
    meta[META_COLS.index("spheremp")] = 1.0
    q = torch.zeros(rows, nel, 16, dtype=torch.float64)
    q[..., 5] = 1.0
    mx = q.clone()
    for r, e in fit:
        mx[r, e, 9] = 1.5
    for r, e in over:
        mx[r, e] = 2.0
    wind = torch.zeros(rows, e16, dtype=torch.float64)
    return (meta, wind, wind, q.reshape(rows, e16),
            torch.eye(4, dtype=torch.float64), 0.0, rows), \
        (mx.reshape(rows, e16), 1.0, 0.0)


def test_torch_limiter_plain_counts_known_deficits():
    fit = {(0, 0), (0, 3), (1, 9), (2, 15)}
    over = {(0, 4), (2, 8)}
    args, mix = _crafted(fit, over)
    want = tracer_limit_plain(*args, mix=mix)
    with record_spans(counters=True) as rec:
        got = tracer_limit_plain(*args, mix=mix)
        assert profiling.limiter_counts("cpu") is not None
    assert torch.equal(got, want)
    n = rec.limiter()
    # 3 rows x 2 warps of 8 elements x 2 passes; pass 1: warp 0 of row 0,
    # warp 1 of rows 1 and 2; pass 2: the carries of (0, 4) and (2, 8); the
    # other 7 warp-passes have no deficit and are skipped
    assert n == {"warp_passes": 3 + 2, "warp_passes_with_deficit": 3 + 2,
                 "warp_passes_skipped": 12 - 5,
                 "element_passes_with_deficit": len(fit) + 2 * len(over)}
    with record_spans(counters=True) as rec:
        tracer_limit_plain(*args, mix=mix, iters=1)
    assert rec.limiter()["element_passes_with_deficit"] == \
        len(fit) + len(over)


@pytest.fixture
def card_launches(monkeypatch):
    """``tracer_limit_cuda``'s CUDA branch on CPU tensors: the check
    reports a card and the library records each launch's name and
    arguments."""
    from tinman_sandbox_tpu_torch.kernels import _build

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(tracer_t, "_check",
                        lambda *a, **kw: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    return calls


def test_torch_limiter_twin_launches_only_with_counters(card_launches,
                                                        monkeypatch):
    args, mix = _crafted(set(), set())
    args = tuple(a.float() if torch.is_tensor(a) else a for a in args)
    mix = (mix[0].float(), *mix[1:])
    twins = tracer_limit_cuda.count_launches
    tracer_limit_cuda(*args, mix=mix)
    assert card_launches[-1][0] == "tracer_limit_launch"
    assert tracer_limit_cuda.count_launches == twins
    counts = torch.zeros(4, dtype=torch.int64)
    monkeypatch.setattr(tracer_t, "limiter_counts", lambda dev: counts)
    tracer_limit_cuda(*args, mix=mix)
    name, launched = card_launches[-1]
    assert name == "tracer_limit_count_launch"
    assert launched[-1] == counts.data_ptr()
    assert len(launched) == len(card_launches[-2][1]) + 1
    assert tracer_limit_cuda.count_launches == twins + 1
