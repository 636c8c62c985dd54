"""Slices 2 and 3 (``benchmark/spans.py``) on the CPU: the attribution of
device operations to the port's spans on a synthetic Chrome trace
(correlation ids, nested spans, another thread's span, an operation
launched outside every port span, one launched before the window), the DSS
split by phase adding up to ``dss_ms``'s reading of the same trace, the
fixer's time, the readers of slice 3, and a whole run of a tiny cell."""
from __future__ import annotations

import argparse
import json

import pytest
import torch

from benchmark import run, spans, spec
from benchmark import trace as tracing
from benchmark.tests import tiny

STEPS = 2


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# (span, start, end) on thread 1, the port's and the harness's
SPANS = [("cadence.step", 5, 505), ("prim.step", 10, 500),
         ("prim.dynamics", 20, 200), ("prim.dynamics.stage", 30, 100),
         ("launch.caar_t4_cuda", 35, 50), ("launch.dss_fixup_cuda", 55, 70),
         ("launch.dss_sweep_cuda", 75, 90), ("prim.hypervis", 210, 300),
         ("prim.hypervis.pass", 215, 290), ("launch.vlap_cuda", 216, 219),
         ("launch.dss_sweep_cuda", 220, 230), ("prim.tracers", 310, 480),
         ("prim.tracers.stage", 320, 470),
         ("launch.tracer_limit_cuda", 322, 328),
         ("launch.dss_fixup_cuda", 329, 330),
         ("launch.dss_sweep_cuda", 330, 340), ("remap", 520, 700),
         ("remap.kernel", 530, 560), ("remap.fixer", 600, 690)]
# (kernel, launched at, device start, device time, correlation)
OPS = [("caar_chunk_kernel<true>", 40, 1000, 50, 1),
       ("dss_fixup_kernel", 60, 1050, 5, 2),
       ("dss_sweep_kernel_false__true__false_", 80, 1060, 30, 3),
       ("vlap_kernel", 217, 1100, 20, 4),
       ("dss_sweep_kernel_true_", 225, 1120, 25, 5),
       ("tracer_kernel<true, false>", 325, 1150, 100, 6),
       ("dss_fixup_kernel", 329.5, 1250, 7, 7),
       ("dss_sweep_kernel_false__true__false_", 335, 1260, 300, 8),
       ("elementwise_kernel<copy>", 503, 1600, 4, 9),
       ("remap_kernel<float>", 540, 1610, 80, 10),
       ("reduce_kernel<sum>", 610, 1700, 11, 11),
       ("elementwise_kernel<mul>", 620, 1720, 13, 12)]


def _events():
    ev = [_x(tracing.WINDOW, "user_annotation", 0, 1990),
          _x("cudaDeviceSynchronize", "cuda_runtime", 900, 1090),
          # before the window: not the window's
          _x("cudaLaunchKernel", "cuda_runtime", -50, 2, corr=99),
          _x("dss_sweep_kernel_early", "kernel", -40, 5, corr=99),
          # another thread's span around a launch of this one
          _x("prim.tracers.stage", "user_annotation", 500, 30, tid=2),
          _x("cudaMalloc", "cuda_runtime", 612, 30)]
    ev += [_x(n, "user_annotation", t0, t1 - t0) for n, t0, t1 in SPANS]
    for name, at, d0, dur, corr in OPS:
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", at, 0.5, corr=corr))
        ev.append(_x(name, "kernel", d0, dur, tid=7, corr=corr))
    return ev


def test_each_operation_takes_the_port_spans_around_its_launch():
    got = spans.attribute(_events(), STEPS)
    paths = {name: path for _, _, name, path in got.ops}
    assert len(got.ops) == len(OPS)
    assert paths["caar_chunk_kernel<true>"] == (
        "prim.step", "prim.dynamics", "prim.dynamics.stage",
        "launch.caar_t4_cuda")
    assert paths["dss_sweep_kernel_true_"] == (
        "prim.step", "prim.hypervis", "prim.hypervis.pass",
        "launch.dss_sweep_cuda")
    assert paths["elementwise_kernel<mul>"] == ("remap", "remap.fixer")
    assert paths["remap_kernel<float>"] == ("remap", "remap.kernel")
    # launched between the step and the remap: another thread's span and
    # the harness's own do not count
    assert paths["elementwise_kernel<copy>"] == ()
    assert got.outside() == [(1600, 1604, "elementwise_kernel<copy>")]
    assert "dss_sweep_kernel_early" not in paths
    assert got.allocs == [("cudaMalloc", ("remap", "remap.fixer"))]


def test_the_dss_phases_add_up_to_dss_ms_and_the_fixer_is_apart():
    events = _events()
    ctx = argparse.Namespace(base=spec.HERE,
                             slice2=spans.attribute(events, STEPS))
    phases = {n: spans.METRICS[n](ctx) for n in spans.DSS_PHASES}
    assert phases == pytest.approx({"dss_dynamics_ms": 0.035 / STEPS,
                                    "dss_hypervis_ms": 0.025 / STEPS,
                                    "dss_tracers_ms": 0.307 / STEPS})
    dss_ms = tracing.read(events, STEPS).ms_per_step(
        spec.kernel_map("dss_ms")["kernels"])
    assert sum(phases.values()) == pytest.approx(dss_ms, rel=1e-12)
    assert spans.fixer_ms(ctx) == pytest.approx(0.024 / STEPS)
    gaps = ctx.slice2.idle_gaps()
    assert all(isinstance(s, float) and s > 0 for _, s in gaps)
    assert any(label.startswith("outside the port") for label, _ in gaps)


def test_the_slice_3_readers():
    s3 = spans.Counted(
        steps=3, stats={"prim.step": (3, 3_000_000, 10), "remap": (1, 600_000,
                                                                   0)},
        limiter={"warp_passes": 400, "warp_passes_with_deficit": 100,
                 "warp_passes_skipped": 0, "element_passes_with_deficit": 150},
        device_allocs=6, launches={"caar_t4_cuda": 9}, step_on_ms=[1.0] * 3,
        step_off_ms=[0.9] * 3)
    ctx = argparse.Namespace(base=spec.HERE, slice3=s3)
    assert spans.host_issue_ms(ctx) == pytest.approx(1.2)
    assert spans.limiter_useful_share(ctx) == pytest.approx(25.0)
    assert spans.device_allocs_per_step(ctx) == pytest.approx(1.0)
    none = argparse.Namespace(base=spec.HERE)
    assert all(read(none) is None for read in spans.METRICS.values())
    lines = spans.notes(None, s3)
    assert lines[0].startswith("span prim.step: 1.000 calls")


def test_a_tiny_cell_runs_its_slices_and_keeps_slice_1():
    cell = tiny.cell("ne30_e3sm_q35", qsize=2)
    plain, _ = run.run_cell(cell, 2 ** 33 + 7, 0.0, True,
                            torch.device("cpu"))
    res, _ = spans.run_cell(cell, 2 ** 33 + 7, 0.0, torch.device("cpu"))
    json.dumps(res)
    assert res["correct"]
    new = set(res["metrics"]) - set(plain["metrics"])
    # no device operation on the CPU: the DSS, the fixer and the
    # allocations have nothing to read
    assert new == {"host_issue_ms", "limiter_useful_share"}
    assert 0.0 < res["metrics"]["limiter_useful_share"]["value"] <= 100.0
    assert res["metrics"]["host_issue_ms"]["value"] > 0.0
    assert set(plain["metrics"]) <= set(res["metrics"])
