"""Raw-kernel CAAR benchmark on the card (counterpart of the raw mode of the
repository's ``bench.py``).

    python -m tinman_sandbox_tpu_torch.bench [--nelem 1024] [--nlev 72]

The reference's methodology (kokkos_init.cpp:108-134): random init from a
numpy seed, f32, fixed time levels, one kernel launch per step with the
vn0u/vn0v/omega_p accumulators chained through every step (updated in place
by each launch, read by the next), a warm-up excluded, and
``torch.cuda.synchronize()`` before each clock read. Prints ONE JSON line.
``bytes_per_step`` is the 21-field count of the root bench (13 field reads,
8 writes, meta ignored); ``fraction_of_triad`` divides by the port's own
saxpby kernel, measured in the same process. A measurement of the card:
raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

__all__ = ["card_name_and_power", "bytes_per_step", "make_problem",
           "run_steps", "main"]


def card_name_and_power():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or None
    where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def bytes_per_step(nelem: int, nlev: int, itemsize: int = 4) -> int:
    """Minimum device-memory traffic of one step in the root bench's count:
    21 [nlev, E16] fields (13 read, 8 written), meta ignored."""
    return 21 * itemsize * nelem * 16 * nlev


def make_problem(nelem: int, nlev: int, device, seed: int = 7):
    """The bench problem packed for ``caar_t4_cuda``: random state
    (``seed``), zero accumulators, random geometry (``seed + 1``), analytic
    hvcoord, dt2 = 0.1, eta_ave_w = 1 (the root bench's raw mode). Returns
    (const, acc): const = (scal, meta, s0, sm1, qdp, pecnd, dvv)."""
    from . import (Config, analytic_hvcoord, random_geometry, random_state,
                   zero_derived)
    from .kernels.caar_t import _scalars, pack_problem_t

    cfg = Config(nelem=nelem, nlev=nlev)
    kw = dict(dtype=torch.float32, device=device)
    state, derived = random_state(cfg, seed=seed, **kw), zero_derived(cfg, **kw)
    geom = random_geometry(cfg, seed=seed + 1, **kw)
    hv = analytic_hvcoord(cfg, **kw)
    p = pack_problem_t(state, derived, geom, hv, cfg)
    s0 = torch.cat([p["u0"], p["v0"], p["t0"], p["dp0"]])
    sm1 = torch.cat([p["um1"], p["vm1"], p["tm1"], p["dpm1"]])
    const = (_scalars(0.1, 1.0, hv, torch.float32, device), p["meta"], s0,
             sm1, p["qdp"], p["pecnd"], p["dvv"])
    return const, (p["vn0u"], p["vn0v"], p["omg"])


def run_steps(const, acc, nsteps: int):
    """``nsteps`` chained ``caar_t4_cuda`` steps at fixed time levels;
    returns the last step's outputs (s1, phi, vn0u, vn0v, omg)."""
    from .kernels.caar_t import caar_t4_cuda

    scal, meta, s0, sm1, qdp, pecnd, dvv = const
    out = None
    for _ in range(nsteps):
        out = caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, *acc, dvv)
        acc = out[2:5]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="tinman_sandbox_tpu_torch.bench")
    ap.add_argument("--nelem", type=int, default=1024)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--nexec", type=int, default=1000,
                    help="steps per timed run")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .kernels.caar_t import caar_t4_cuda
    from .kernels.saxpby import saxpby_bandwidth_gbs

    dev = resolve_device("cuda")
    const, acc = make_problem(args.nelem, args.nlev, dev)
    launches0 = caar_t4_cuda.launches
    run_steps(const, acc, 2)                  # warm-up (first build), excluded
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(args.reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = run_steps(const, acc, args.nexec)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise RuntimeError("bench: non-finite CAAR output")
    launches = caar_t4_cuda.launches - launches0
    triad = saxpby_bandwidth_gbs(device=dev)
    nbytes = bytes_per_step(args.nelem, args.nlev)
    gbs = nbytes * args.nexec / best / 1e9
    result = {
        "metric": "caar_gridpoint_updates_per_s",
        "config": f"{args.nelem}x{args.nlev}x16 float32 nexec={args.nexec} "
                  f"reps={args.reps} kernel=caar_t4_cuda",
        "seconds": best,
        "us_per_step": best / args.nexec * 1e6,
        "gridpoints_per_s": args.nelem * args.nlev * 16 * args.nexec / best,
        "bytes_per_step": nbytes,
        "achieved_gb_per_s": gbs,
        "triad_gb_per_s": triad,
        "fraction_of_triad": gbs / triad,
        "kernel_launches": launches,
        "device": torch.cuda.get_device_name(dev),
        "card": card_name_and_power(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
