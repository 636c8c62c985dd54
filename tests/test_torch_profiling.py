"""The port's profiling layer (``tinman_sandbox_tpu_torch/profiling.py``) on
the CPU: the native timer (``native/timing/tinman_timing.cpp`` built with
this machine's ``g++`` into ``build/torch_native/``) and the pure-Python
path count calls, nesting, min and max alike (as tests/test_profiling.py
holds the JAX package's); the native path's usr CPU time and per-parent
rows; ``summary`` writes the table; a mismatched stop raises; ``trace``
writes a Chrome trace with its body marked, and ``busy_share`` reads the
union of device intervals, the window (with and without the mark), the
counts and the top operations off a hand-made trace and gives a share in
[0, 1] on the CPU trace."""
import json
import os
import time

import pytest
import torch

from tinman_sandbox_tpu_torch import profiling
from tinman_sandbox_tpu_torch.profiling import (
    TRACE_WINDOW,
    Timers,
    busy_share,
    trace,
    trace_path,
)


def _exercise(t, tmp_path):
    with t.region("outer"):
        with t.region("inner"):
            time.sleep(0.01)
        with t.region("inner"):
            time.sleep(0.01)
    calls, total, mn, mx = t.get("inner")
    assert calls == 2
    assert total >= 0.02 and mn >= 0.009 and mn <= mx <= total
    outer = t.get("outer")
    assert outer[0] == 1 and outer[1] >= total
    assert t.get("nope") is None
    path = str(tmp_path / "Timing.dat")
    t.summary(path)
    text = open(path).read()
    assert "outer" in text and "inner" in text and "calls" in text
    with pytest.raises(RuntimeError, match="mismatched"):
        t.start("a")
        t.stop("b")


@pytest.mark.parametrize("native", [True, False])
def test_torch_timers(tmp_path, native):
    t = Timers(native=native)
    assert t.is_native == native, "the native timer did not build or load"
    t.reset()
    _exercise(t, tmp_path)
    t.reset()
    assert t.get("inner") is None


def test_torch_native_timer_build_and_attribution(tmp_path):
    t = Timers()
    assert t.is_native
    lib = profiling._library_path()
    assert os.path.exists(lib) and \
        os.path.dirname(lib) == profiling.NATIVE_DIR
    assert not lib.startswith(os.path.join(profiling._REPO, "native"))
    t.reset()
    with t.region("outer"):
        with t.region("leaf"):
            sum(i * i for i in range(400000))       # CPU-bound
    with t.region("outer2"):
        with t.region("leaf"):
            time.sleep(0.03)                        # idle
    calls, total, mn, mx, usr, sys_ = t.get_full("leaf")
    assert calls == 2 and usr > 0.005 and total >= 0.03
    path = tmp_path / "Timing.dat"
    t.summary(str(path))
    lines = path.read_text().splitlines()
    leaf_rows = [ln for ln in lines if ln.lstrip().startswith("leaf")]
    assert len(leaf_rows) == 2                      # one row a parent
    assert "self_s" in lines[0] and "usr_s" in lines[0]
    t.reset()


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def test_torch_busy_share_of_a_hand_made_trace(tmp_path):
    events = [
        _event("cpu_op", "aten::add", 100.0, 5.0),          # window opens
        _event("kernel", "k_a", 110.0, 20.0),               # 110-130
        _event("kernel", "k_b", 120.0, 20.0),               # 120-140 (overlap)
        _event("gpu_memcpy", "Memcpy HtoD", 150.0, 10.0),   # 150-160
        _event("kernel", "k_a", 170.0, 10.0),               # 170-180
        _event("cuda_runtime", "cudaDeviceSynchronize", 175.0, 25.0),
        _event("kernel", "late", 300.0, 50.0),              # past the sync
        {"ph": "i", "name": "marker", "ts": 90.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = busy_share(str(path), top=2)
    assert r["window_s"] == pytest.approx(100e-6)           # 100 .. 200
    assert r["busy_s"] == pytest.approx(50e-6)              # 30 + 10 + 10
    assert r["busy_share"] == pytest.approx(0.5)
    assert r["top"][0][0] == "k_a" and r["top"][0][2] == 2
    assert r["top"][0][1] == pytest.approx(30e-6)
    assert len(r["top"]) == 2
    assert r["kernels"] == {"k_a": 2, "k_b": 1, "Memcpy HtoD": 1}
    # with the scope's mark, the window is the body's: from the mark's
    # start to the end of the last synchronisation inside it
    marked = events + [
        _event("user_annotation", TRACE_WINDOW, 115.0, 90.0),   # 115-205
        _event("cuda_runtime", "cudaDeviceSynchronize", 260.0, 5.0)]
    path.write_text(json.dumps({"traceEvents": marked}))
    r = busy_share(str(path))
    assert r["window_s"] == pytest.approx(85e-6)            # 115 .. 200
    assert r["busy_s"] == pytest.approx(45e-6)              # 25 + 10 + 10
    assert r["kernels"] == {"k_a": 2, "k_b": 1, "Memcpy HtoD": 1}


def test_torch_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path), device="cpu"):
        x = torch.ones(64, 64)
        for _ in range(3):
            x = x @ x / 64
    path = trace_path(str(tmp_path))
    assert os.path.exists(path)
    r = busy_share(path)
    assert 0.0 <= r["busy_share"] <= 1.0 and r["window_s"] > 0
    assert r["busy_s"] == 0.0 and r["top"] == []      # no device events
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert TRACE_WINDOW in names and "aten::mm" in names
