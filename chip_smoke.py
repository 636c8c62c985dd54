#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``tinman_sandbox_tpu_torch``) on one
NVIDIA card and check it, phase by phase:

  1. the card's name and power limit; build both CUDA kernels from
     ``tinman_sandbox_tpu_torch/csrc`` (nvcc, sm_90a) and time the build;
  2. saxpby: the kernel against its plain version (bitwise, f32) at
     8192 x 4096, with kernel / plain / library times and GB/s;
  3. CAAR: the kernel against its plain version on the card at 1024 x 72 and
     5,400 x 72 (random init from a numpy seed, f32), each output field on
     its own (u1, v1, t1, dp1, phi and the in-place accumulators) within
     5e-5 scaled max-abs error, in three cases (``caar_cases``): the bench
     problem, and two probes that zero what would hide a tendency term
     below f32 resolution;
  4. golden: analytic init at 3 elements through ``caar_t`` on the card,
     T/u/v within 5e-5 x max|gold| of the golden arrays (f32 against f64);
  5. the main path, with every launch count set to 0 just before it and read
     just after: the CLI at 1024 elements x 100 steps (golden-checked), the
     packed leapfrog loop for 10 steps at 5,400 x 72 against the same loop
     on the plain version (1e-4 scaled, all finite; this checks the loop's
     rotation and accumulators, while phase 3 holds the tendencies), and
     the raw-kernel bench at 1024 x 72;
  6. one JSON line of kernels (launches on the main path, errors, times,
     bounds), the card line, and last the result line.

Any failure raises and exits non-zero before the result line is printed.
Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, non-tensor FP32
# FP32 operations per grid point of one CAAR step, counted from
# csrc/caar.cu (derivative contractions, scans, tendencies, apply)
CAAR_OPS_PER_POINT = 190
CAAR_TOL = 5e-5                # the repo's on-chip equivalence gate
LEAPFROG_TOL = 1e-4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    from tinman_sandbox_tpu_torch.bench import card_name_and_power

    line = card_name_and_power()
    if not line:
        raise RuntimeError("nvidia-smi did not report the card")
    return line


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def scaled_err(a, b) -> float:
    """max|a - b| / max|b|; the plain max|a - b| where b is all zero."""
    b = b.double()
    diff, scale = float((a.double() - b).abs().max()), float(b.abs().max())
    return diff / scale if scale > 0 else diff


def caar_cases(const, acc):
    """The CAAR gate's cases as (name, args), args the operands of
    ``caar_t4_cuda`` / ``caar_t4_plain``. s1 = spheremp*(sm1 + dt2*tendency).
    On the bench problem dt2 * T's tendency is ~2e-3 against T ~ 300, near
    f32 resolution, and in u and v the vorticity and kinetic-energy terms
    are ~1e-7 of the Coriolis and pressure-gradient terms. A kernel that
    dropped one of them would pass there, so besides the bench problem:
      tend:  sm1 = 0, so s1 is the scaled tendency itself;
      vort:  sm1 = 0, T = 0, phis = 0, fcor = 0 and a random pecnd, so the
             vorticity, kinetic-energy and pecnd gradients carry u1 and v1."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS

    scal, meta, s0, sm1, qdp, pecnd, dvv = const
    k = qdp.shape[0]
    zero = torch.zeros_like(sm1)
    cold = s0.clone()
    cold[2 * k:3 * k] = 0
    flat = meta.clone()
    flat[META_COLS.index("phis")] = 0
    flat[META_COLS.index("fcor")] = 0
    rng = np.random.default_rng(3)
    pec = torch.from_numpy(rng.uniform(-1, 1, tuple(pecnd.shape)).astype(
        np.float32)).to(pecnd.device)
    return [("bench", (scal, meta, s0, sm1, qdp, pecnd, *acc, dvv)),
            ("tend", (scal, meta, s0, zero, qdp, pecnd, *acc, dvv)),
            ("vort", (scal, flat, cold, zero, qdp, pec, *acc, dvv))]


def caar_field_errs(got, want, nlev) -> dict:
    """Scaled error of each output field on its own: the four row blocks of
    s1, phi and the three accumulators."""
    names = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg")
    pairs = list(zip(got[0].split(nlev), want[0].split(nlev)))
    pairs += list(zip(got[1:], want[1:]))
    return {n: scaled_err(g, w) for n, (g, w) in zip(names, pairs)}


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_saxpby(dev):
    import torch

    from tinman_sandbox_tpu_torch.kernels.saxpby import saxpby_cuda, saxpby_plain

    rows, cols, a, b = 8192, 4096, 3.0, -0.25
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, cols, generator=gen, device=dev)
    y = torch.randn(rows, cols, generator=gen, device=dev)
    want = saxpby_plain(a, b, x, y)
    got = saxpby_cuda(a, b, x.clone(), y)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("saxpby kernel differs from its plain version")
    xk = x.clone()
    k_ms = cuda_ms(lambda: saxpby_cuda(1.0, 1e-6, xk, y), 50)
    p_ms = cuda_ms(lambda: saxpby_plain(1.0, 1e-6, x, y), 20)
    xl = x.clone()
    l_ms = cuda_ms(lambda: xl.mul_(1.0).add_(y, alpha=1e-6), 50)
    n = rows * cols
    nbytes = 3 * n * 4
    bnd, by = bound_ms(nbytes, 3 * n)
    print(f"phase 2 saxpby {rows}x{cols} f32: bitwise equal; kernel "
          f"{k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s), plain "
          f"{p_ms:.4f} ms, library mul_+add_ {l_ms:.4f} ms, bound "
          f"{bnd:.4f} ms ({by})")
    return dict(name="saxpby_cuda", route="cuda",
                source="tinman_sandbox_tpu_torch/csrc/saxpby.cu",
                replaces="tinman_sandbox_tpu/kernels/saxpby.py:24",
                max_abs_err=float((got - want).abs().max()), ms=k_ms,
                plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms)


def phase_caar(dev):
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda, caar_t4_plain

    row = None
    for nelem in (1024, 5400):
        nlev = 72
        const, acc = bench.make_problem(nelem, nlev, dev, seed=7)
        max_abs = 0.0
        for case, args in caar_cases(const, acc):
            want = caar_t4_plain(*args)
            kacc = [x.clone() for x in args[6:9]]
            got = caar_t4_cuda(*args[:6], *kacc, args[9])
            torch.cuda.synchronize()
            for g in got:
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"caar {nelem} {case}: non-finite")
            errs = caar_field_errs(got, want, nlev)
            print(f"phase 3 caar {nelem}x{nlev} {case}: scaled errors "
                  + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            if max(errs.values()) > CAAR_TOL:
                raise AssertionError(
                    f"caar {nelem}x{nlev} {case}: {errs} > {CAAR_TOL}")
            max_abs = max(max_abs, *(float((g - w).abs().max())
                                     for g, w in zip(got, want)))
        scal, meta, s0, sm1, qdp, pecnd, dvv = const
        kacc = [x.clone() for x in acc]
        k_ms = cuda_ms(lambda: caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd,
                                            *kacc, dvv), 20)
        p_ms = cuda_ms(lambda: caar_t4_plain(scal, meta, s0, sm1, qdp, pecnd,
                                             *acc, dvv), 5)
        e16 = nelem * 16
        # 21 fields, the 13 meta rows the kernel reads, dvv and 3 scalars
        nbytes = (21 * nlev + 13) * e16 * 4 + 16 * 4 + 3 * 4
        bnd, by = bound_ms(nbytes, CAAR_OPS_PER_POINT * e16 * nlev)
        print(f"phase 3 caar {nelem}x{nlev}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {bnd:.4f} ms ({by}, {nbytes} B)")
        if nelem == 1024:
            row = dict(name="caar_t4_cuda", route="cuda",
                       source="tinman_sandbox_tpu_torch/csrc/caar.cu",
                       replaces="tinman_sandbox_tpu/kernels/caar_pallas_t.py:542",
                       max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                       bound_ms=bnd, bound_by=by, library_ms=None)
    return row


def phase_golden(dev):
    import numpy as np
    import torch

    import tinman_sandbox_tpu_torch as tt
    from tinman_sandbox_tpu_torch.golden import golden_caar
    from tinman_sandbox_tpu_torch.kernels import caar_t

    cfg = tt.Config(nelem=3, nlev=72)
    kw = dict(dtype=torch.float32, device=dev)
    s, _ = caar_t(tt.analytic_state(cfg, **kw), tt.analytic_derived(cfg, **kw),
                  tt.analytic_geometry(cfg, **kw), tt.analytic_hvcoord(cfg, **kw),
                  cfg, 1.0, 1.0, device=dev)
    gold = golden_caar()
    line = []
    for field, key in (("t", "T"), ("u", "v1"), ("v", "v2")):
        got = getattr(s, field)[cfg.np1, 0].double().cpu().numpy()
        diff = float(np.max(np.abs(got - gold[key])))
        lim = CAAR_TOL * float(np.max(np.abs(gold[key])))
        if not diff < lim:
            raise AssertionError(f"golden {key}: {diff:.3e} >= {lim:.3e}")
        line.append(f"{key} {diff:.3e} (limit {lim:.3e})")
    print("phase 4 golden (f32 kernel vs f64 gold): " + ", ".join(line))


def phase_main_path(dev):
    import torch

    import tinman_sandbox_tpu_torch as tt
    from tinman_sandbox_tpu_torch import bench, cli
    from tinman_sandbox_tpu_torch.golden import golden_caar
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        _leapfrog_loop, caar_t4_plain, run_leapfrog_t)

    # CLI at 1024 elements, golden-checked (element 1 is the golden element
    # at any element count)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--num-elems", "1024", "--num-exec", "100",
                       "--golden-check"])
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli exited {rc}:\n{out}")
    speed = [ln for ln in out.splitlines() if "Mgridpoints/s" in ln]
    gold = [ln for ln in out.splitlines() if "golden diffs" in ln]
    print("phase 5 cli 1024x72 x100:" + speed[0].split(":", 1)[1])
    print("phase 5 cli" + gold[0].split("---", 1)[1])
    diffs = gold[0].split("golden diffs: T")[1].split()
    ref = golden_caar()
    for key, diff in (("T", diffs[0]), ("v1", diffs[2]), ("v2", diffs[4])):
        lim = CAAR_TOL * float(abs(ref[key]).max())
        if not float(diff) < lim:
            raise AssertionError(f"cli golden {key}: {diff} >= {lim:.3e}")

    # packed leapfrog loop at 5,400 x 72 (random init is not a balanced
    # atmosphere: dt = 0.05 keeps 10 steps finite, as in the unit tests)
    cfg = tt.Config(nelem=5400, nlev=72, dt=0.05)
    kw = dict(dtype=torch.float32, device=dev)
    prob = (tt.random_state(cfg, seed=7, **kw), tt.zero_derived(cfg, **kw),
            tt.random_geometry(cfg, seed=8, **kw), tt.analytic_hvcoord(cfg, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ks, kd, kc = run_leapfrog_t(*prob, cfg, 10, device=dev)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    ps, pd, pc = _leapfrog_loop(caar_t4_plain, *prob, cfg, 10, True, dev)
    errs = {}
    for name in ("u", "v", "t", "dp3d"):
        a, b = getattr(ks, name), getattr(ps, name)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"leapfrog: non-finite {name}")
        errs[name] = scaled_err(a, b)
    for name in ("vn0_u", "vn0_v", "omega_p", "phi"):
        errs[name] = scaled_err(getattr(kd, name), getattr(pd, name))
    if max(errs.values()) > LEAPFROG_TOL or kc != pc:
        raise AssertionError(f"leapfrog: {errs} > {LEAPFROG_TOL}")
    print(f"phase 5 leapfrog 5400x72 x10 (kernel {k_s:.3f} s incl. pack): "
          "scaled errors vs plain " + " ".join(f"{k} {v:.2e}"
                                               for k, v in errs.items()))

    # raw-kernel bench at 1024 x 72
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = bench.main(["--nelem", "1024", "--nlev", "72", "--nexec", "500",
                          "--reps", "3"])
    print("phase 5 bench " + buf.getvalue().strip())
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        from tinman_sandbox_tpu_torch.kernels import _build
        from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
        from tinman_sandbox_tpu_torch.kernels.saxpby import saxpby_cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_kernels()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        log = _build.ptxas_log(name)
        if not os.path.exists(log):                 # built by an older tree
            print(f"phase 1 ptxas {name}: no report (cached build)")
            continue
        with open(log) as f:
            for ln in f:
                if "registers" in ln or "spill" in ln or "error" in ln.lower():
                    print(f"phase 1 ptxas {name}: " + ln.strip())

    rows = {"saxpby_cuda": phase_saxpby(dev), "caar_t4_cuda": phase_caar(dev)}
    phase_golden(dev)

    caar_t4_cuda.launches = 0
    saxpby_cuda.launches = 0
    bench_res = phase_main_path(dev)
    launches = {"caar_t4_cuda": caar_t4_cuda.launches,
                "saxpby_cuda": saxpby_cuda.launches}
    print(f"phase 6 main-path launches: {json.dumps(launches)}; bench "
          f"{bench_res['us_per_step']:.2f} us/step, "
          f"{bench_res['achieved_gb_per_s']:.1f} GB/s, "
          f"fraction_of_triad {bench_res['fraction_of_triad']:.3f}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    kernels = []
    for name in ("caar_t4_cuda", "saxpby_cuda"):
        r = rows[name]
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
