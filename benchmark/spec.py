"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own under this folder:

  * ``configs/<config>.json``: the deployment (grid, levels, tracers, the
    step's settings), at the path the configuration's ``file`` gives;
  * ``traffic/<traffic>.json``: the mix of steps (remap cadence, warm-up,
    the traced slice, the checked sample);
  * ``metrics/<metric>.py``: the reader of a per-layer metric, with
    ``metrics/<metric>.json`` beside it where the metric reads kernels by
    name (its kernel-name map). A metric named ``<base>.<suffix>`` (the
    same quantity in cells that report another end-to-end metric, such as
    ``caar_ms.dispatch``) takes its own files where they exist and
    ``<base>``'s otherwise;
  * ``limits/<cell>.json``: the limit of each number the correctness check
    compares in that cell.

Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; no code here changes. A configuration holds the keys of
``CONFIG_KEYS`` and no others, each with a value the program's set-up and
step and the reference both carry out (``check_config``): a key or value
that neither reads is refused, never ignored.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, with its entry's name
    traffic: dict           # the traffic file, with its name
    end_to_end: list        # the metrics of BENCHMARK.json this cell reports
    per_layer: list
    limits: dict            # number -> limit
    base: str               # the folder the cell's files were found in


# what a configuration may say: the keys the harness reads, with the values
# it carries out (a type, or the tuple of admitted values), and the keys
# that only describe
CONFIG_KEYS = {
    "ne": int, "nelem": int, "np": (4,), "nlev": int, "qsize": int,
    "dtype": ("float32",), "dt": float, "nu": float,
    "hypervis_subcycle": int, "qsplit": int, "limiter": (True, False),
    "limiter_iters": int, "remap": ("plm",), "mass_fixer": (True, False),
    "init": ("noise_at_rest",),
}
DESCRIPTIVE = ("deployment", "source", "assumed", "reduced")


def check_config(config: dict) -> None:
    """Refuse a configuration with a key the harness does not read or a
    value it does not carry out."""
    for key, value in config.items():
        if key in DESCRIPTIVE:
            continue
        if key not in CONFIG_KEYS:
            raise ValueError(f"configuration key {key!r} is not carried "
                             f"out by the benchmark (it reads "
                             f"{sorted(CONFIG_KEYS)})")
        want = CONFIG_KEYS[key]
        if isinstance(want, tuple):
            ok = any(value is w if isinstance(w, bool) else
                     (value == w and not isinstance(value, bool))
                     for w in want)
        elif want is float:
            ok = isinstance(value, (int, float)) \
                and not isinstance(value, bool)
        else:
            ok = isinstance(value, want) and not isinstance(value, bool)
        if not ok:
            raise ValueError(f"configuration {key}={value!r}: the "
                             f"benchmark carries out {want}")
    missing = sorted(set(CONFIG_KEYS) - set(config))
    if missing:
        raise ValueError(f"configuration lacks {missing}")
    if config["nelem"] != 6 * config["ne"] ** 2:
        raise ValueError("configuration: nelem is not 6 ne^2")


def _reports(metric: dict, cell: str, end_to_end: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in end_to_end


def load_cell(name: str, bench: dict | None = None,
              base: str = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``) with its files read from ``base``."""
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = _json(os.path.join(os.path.dirname(base),
                                entry["file"]))
    check_config(config)
    config["name"] = entry["name"]
    traffic = _json(os.path.join(base, "traffic", w["traffic"] + ".json"))
    traffic["name"] = w["traffic"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    limits = _json(os.path.join(base, "limits", name + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer,
                limits=limits, base=base)


def metric_file(metric: str, ext: str, base: str = HERE) -> str | None:
    """``metrics/<metric><ext>``, else ``metrics/<base name><ext>`` (the
    name up to its first dot), else None."""
    for name in (metric, metric.split(".")[0]):
        path = os.path.join(base, "metrics", name + ext)
        if os.path.exists(path):
            return path
    return None


def kernel_map(metric: str, base: str = HERE) -> dict | None:
    """The metric's ``.json`` (the kernels it reads, by name pattern), or
    None where it has none."""
    path = metric_file(metric, ".json", base)
    return _json(path) if path else None


def reader(metric: str, base: str = HERE):
    """The ``read(ctx)`` function of the metric's ``.py``."""
    path = metric_file(metric, ".py", base)
    if path is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} in "
                                f"{os.path.join(base, 'metrics')}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def work(layer: str, base: str = HERE):
    """The ``work(shape)`` function of ``work/<layer>.py``: the bytes and
    operations one step of the layer must move and compute."""
    path = os.path.join(base, "work", layer + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_work_{layer}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.work
