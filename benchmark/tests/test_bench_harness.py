"""The harness on the CPU: the frozen work counts against the port's byte
counts, discovery of new files by name, the result line's schema, the
checked sample, the TF32 rounding and the import boundaries."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run, spec
from benchmark.reference.tf32 import round_tf32
from benchmark.tests import tiny

CPU = torch.device("cpu")
LAYERS = ("caar", "tracer", "dss", "vlap")


@pytest.mark.parametrize("ne", [30, 120])
@pytest.mark.parametrize("qsize", [1, 35])
def test_layer_bytes_are_the_port_bytes_without_the_slab(ne, qsize):
    """The frozen layer counts add up to the port bench's
    ``prim_bytes_per_step`` less the fix-lane slab it counts."""
    from tinman_sandbox_tpu_torch.bench import prim_bytes_per_step
    from tinman_sandbox_tpu_torch.dist import make_structured_plan
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables

    from benchmark.reference import grid

    nlev = 72
    g = grid.build(ne)
    nfix = fix_tables(make_structured_plan(g["gdof"], ne), "cpu").nfix
    shape = dict(nelem=6 * ne * ne, nlev=nlev, qsize=qsize, qsplit=1,
                 rsplit=3, subcycle=1)
    ours = sum(spec.work(layer)(shape)["bytes"] for layer in LAYERS)
    # the slab: written by each producer and read by its fixup
    slab = 4 * 2 * nfix * nlev * (3 * 4 + 2 * 3 + 3 * qsize)
    port = prim_bytes_per_step(ne, nlev, nfix, qsize, 1, hypervis=True)
    assert ours == port - slab


def test_step_work_is_the_compulsory_traffic():
    w = spec.work("step")(dict(nelem=5400, nlev=72, qsize=35, qsplit=1,
                               rsplit=3, subcycle=1))
    assert w["bytes"] == (2 * (4 + 35 + 3) * 72 + 2 * 72 + 16) * 86400 * 4


def _copy_tree(tmp_path):
    """The benchmark folder and BENCHMARK.json copied to a new root."""
    root = tmp_path / "root"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    return root, bench


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root, bench = _copy_tree(tmp_path)
    base = str(root / "benchmark")
    cfg = json.loads((root / "benchmark/configs/e3sm_ne30_L72.json")
                     .read_text())
    cfg["qsize"] = 10
    (root / "benchmark/configs/e3sm_ne30_L72_q10.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/cadence_rsplit3.json")
                         .read_text())
    traffic["rsplit"] = 1
    (root / "benchmark/traffic/cadence_rsplit1.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/metrics/tracer_share.json").write_text(
        json.dumps({"kernels": ["tracer_kernel"]}))
    (root / "benchmark/metrics/tracer_share.py").write_text(
        "def read(ctx):\n    return 42.0 + ctx.step_ms\n")
    (root / "benchmark/limits/ne30_q10_rsplit1.json").write_text(
        json.dumps({n: 1.0 for n in tiny.NAMES}))
    bench["configs"].append({"name": "e3sm_ne30_L72_q10", "source": "x",
                             "file": "benchmark/configs/"
                                     "e3sm_ne30_L72_q10.json",
                             "reduced": ["qsize"]})
    bench["workloads"].append({"name": "ne30_q10_rsplit1",
                               "config": "e3sm_ne30_L72_q10",
                               "traffic": "cadence_rsplit1", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "tracer_share", "unit": "%",
                               "better": "higher",
                               "source": "device_trace", "layer": "x",
                               "moves": "step_ms",
                               "workloads": ["ne30_q10_rsplit1"]})
    cell = spec.load_cell("ne30_q10_rsplit1", bench, base)
    assert cell.config["qsize"] == 10 and cell.traffic["rsplit"] == 1
    assert [m["name"] for m in cell.per_layer][-1] == "tracer_share"
    assert spec.kernel_map("tracer_share", base) == {
        "kernels": ["tracer_kernel"]}

    class Ctx:
        step_ms = 1.0

    assert spec.reader("tracer_share", base)(Ctx()) == 43.0
    # the cells already there do not report the new metric
    old = spec.load_cell("ne30_e3sm_q35", bench, base)
    assert "tracer_share" not in [m["name"] for m in old.per_layer]


def test_every_metric_of_the_benchmark_has_its_reader_and_map():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        with open(spec.metric_file(m["name"], ".py")) as f:
            text = f.read()
        reads_kernels = "layer_ms" in text or "roofline(" in text
        if reads_kernels:
            assert spec.kernel_map(m["name"])["kernels"], m["name"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        assert sorted(cell.limits) == sorted(tiny.NAMES)


@pytest.mark.parametrize("name", ["ne30_e3sm_q35", "ne30_tinman_q1",
                                  "ne120_e3sm_q35"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line(trace, name):
    cell = tiny.cell(name, qsize=1 if name == "ne30_tinman_q1" else 3)
    res, lines = run.run_cell(cell, 2 ** 33 + 5, 0.0, bool(trace), CPU)
    json.dumps(res)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
        names = {m["name"] for m in cell.per_layer}
        assert set(res["metrics"]) <= names
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert [ln.split(":")[0] for ln in lines] == \
        [f"check {k}" for k in res["check"]]
    for k, (value, limit) in res["check"].items():
        assert value <= limit


def test_the_sample_lies_in_the_window_before_a_remap():
    traffic = spec.load_cell("ne30_e3sm_q35").traffic
    for seed in (0, 1, 2 ** 31 + 11, 2 ** 40):
        j = run.sample(seed, traffic, 3)
        assert traffic["warmup_steps"] < j < traffic["warmup_steps"] \
            + traffic["sample_within"] and (j + 1) % 3 == 0
        assert run.sample(seed, traffic, 3) == j


def test_a_suffixed_metric_takes_its_base_files_unless_it_has_its_own(
        tmp_path):
    root, _ = _copy_tree(tmp_path)
    base = str(root / "benchmark")
    assert spec.kernel_map("caar_ms.dispatch", base) == \
        spec.kernel_map("caar_ms", base)
    assert spec.metric_file("caar_ms.dispatch", ".py", base).endswith(
        os.path.join("metrics", "caar_ms.py"))
    (root / "benchmark/metrics/caar_ms.dispatch.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    assert spec.reader("caar_ms.dispatch", base)(None) == 7.0
    assert spec.kernel_map("no_such_metric.dispatch", base) is None
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.dispatch", base)


@pytest.mark.parametrize("change", [
    {"dtype": "bfloat16"}, {"remap": "ppm"}, {"storage": "bf16_aux"},
    {"limiter": "yes"}, {"mass_fixer": 1}, {"np": 8}, {"init": "bubble"},
    {"qsize": 2.5}, {"nelem": 5401}, {"limiter_iters": None}])
def test_a_configuration_the_harness_does_not_carry_out_is_refused(change):
    cfg = json.loads(open(os.path.join(
        spec.HERE, "configs", "e3sm_ne30_L72.json")).read())
    spec.check_config(cfg)
    cfg.update(change)
    with pytest.raises(ValueError):
        spec.check_config(cfg)


@pytest.mark.parametrize("key", sorted(spec.CONFIG_KEYS))
def test_a_configuration_without_a_key_is_refused(key):
    cfg = json.loads(open(os.path.join(
        spec.HERE, "configs", "e3sm_ne30_L72.json")).read())
    del cfg[key]
    with pytest.raises(ValueError):
        spec.check_config(cfg)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -3.0e-3])
    y = round_tf32(x)
    assert y[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0]
    assert abs(y[5] / x[5] - 1) < 2 ** -11


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules(sub=""):
    for dirpath, _, files in os.walk(os.path.join(spec.HERE, sub)):
        if "tests" in dirpath.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    for path in _modules():
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in run.FORBIDDEN, (path, name)
    for path in _modules("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "tinman_sandbox_tpu_torch", \
                (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys, torch; from benchmark import run, program; "
            "from benchmark.tests import tiny; "
            "run.run_cell(tiny.cell(), 3, 0.0, True, "
            "torch.device('cpu')); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_there_is_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ne30_tinman_q1", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
