"""Command-line driver for the raw CAAR benchmark (counterpart of the raw
path of ``tinman_sandbox_tpu/cli.py``).

    python -m tinman_sandbox_tpu_torch --num-elems 1024 --num-exec 100
    python -m tinman_sandbox_tpu_torch --device cpu --kernel plain \\
        --num-elems 3 --num-exec 2 --golden-check

``--kernel cuda`` (default) runs the packed-layout step through the CUDA
kernel wrapper; on ``--device cpu`` that wrapper runs its plain version.
``--kernel plain`` runs the array-form step and is allowed only on the CPU.
The CUDA kernel is float32 only; ``--dtype`` defaults to float32 on the card
and float64 (the oracle path) on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

# flags of the JAX CLI whose paths are not ported yet
_NOT_PORTED = ("dss", "rk", "prim", "ne", "checkpoint", "restore")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch",
        description="HOMME CAAR dynamical-core sandbox on PyTorch / CUDA",
    )
    ap.add_argument("--num-elems", "--tinman-num-elems", type=int, default=10,
                    dest="num_elems")
    ap.add_argument("--num-exec", "--tinman-num-exec", type=int, default=1,
                    dest="num_exec")
    ap.add_argument("--dump-res", "--tinman-dump-res", default="no",
                    choices=("yes", "no"), dest="dump_res")
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"),
                    help="float32 on the card (default there); float64 "
                         "(default on the CPU) only with --device cpu")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kernel", default="cuda", choices=("cuda", "plain"),
                    help="cuda = packed CUDA kernel (its plain version on "
                         "CPU tensors); plain = array form, CPU only")
    ap.add_argument("--init", default="analytic",
                    choices=("analytic", "random"),
                    help="analytic = golden-comparable init (main.F90:103-154)")
    ap.add_argument("--leapfrog", action="store_true",
                    help="rotate time levels each step (real integration)")
    ap.add_argument("--timing-file", default=None,
                    help="write named-region timer summary (Timing.dat analog)")
    ap.add_argument("--golden-check", action="store_true",
                    help="compare element 1 vs test_mod.F90 golden arrays")
    ap.add_argument("--dt", type=float, default=600.0)
    # accepted so that they fail with a clear message, not an argparse error
    ap.add_argument("--dss", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rk", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--prim", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ne", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--restore", default=None, help=argparse.SUPPRESS)
    return ap


def _usage_error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag) not in (None, False):
            return _usage_error(
                f"--{flag} is not yet ported to tinman_sandbox_tpu_torch "
                f"(the raw CAAR path is); use python -m tinman_sandbox_tpu")
    if args.kernel == "plain" and args.device != "cpu":
        return _usage_error("--kernel plain runs only with --device cpu")
    dtype_name = args.dtype or ("float32" if args.device == "cuda"
                                else "float64")
    if args.device == "cuda" and dtype_name != "float32":
        return _usage_error("the CUDA kernel is float32 only; use "
                            "--dtype float32 or --device cpu")

    import numpy as np
    import torch

    from . import (
        Config, analytic_derived, analytic_geometry, analytic_hvcoord,
        analytic_state, random_geometry, random_state, zero_derived,
    )
    from .device import resolve_device
    from .kernels import caar_array, caar_t
    from .ops.norms import dump_results, print_results_2norm
    from .profiling import Timers
    from .timeloop import check_dp3d, rotated

    dev = resolve_device(args.device)
    dtype = getattr(torch, dtype_name)
    nelem = args.num_elems
    cfg = Config(nelem=nelem, nlev=args.nlev, dt=args.dt)
    kw = dict(dtype=dtype, device=dev)
    if args.init == "analytic":
        state, derived = analytic_state(cfg, **kw), analytic_derived(cfg, **kw)
        geom = analytic_geometry(cfg, **kw)
    else:
        state, derived = random_state(cfg, seed=7, **kw), zero_derived(cfg, **kw)
        geom = random_geometry(cfg, seed=8, **kw)
    hv = analytic_hvcoord(cfg, **kw)
    timers = Timers(dev)

    mode = "cuda" if args.kernel == "cuda" else "plain array-form"
    print(f" --- {args.num_exec} executions on {nelem} elements x {cfg.nlev} "
          f"levels ({mode} kernel, {dtype_name}, {dev.type})")
    if args.kernel == "cuda" and dev.type == "cpu":
        print(" --- cuda kernel on CPU tensors: its plain version runs")
    print_results_2norm(state, "Initial")

    dt2 = 1.0 if args.init == "analytic" else args.dt
    eta = 1.0
    step = caar_t if args.kernel == "cuda" else caar_array

    def one_step(s, d, c):
        return step(s, d, geom, hv, c, dt2, eta, device=dev)

    one_step(state, derived, cfg)       # warm-up (first build), excluded
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    timers.start("main loop")
    t0 = time.perf_counter()
    c = cfg
    for _ in range(args.num_exec):
        with timers.region("caar compute"):
            state, derived = one_step(state, derived, c)
        if args.leapfrog:
            c = rotated(c)
    timers.stop("main loop")
    wall = time.perf_counter() - t0

    print_results_2norm(state, "Final")
    # after the final rotation the freshest level is c.n0, not c.np1
    c_chk = dataclasses.replace(c, np1=c.n0) if args.leapfrog else c
    ok, mn = check_dp3d(state, c_chk)
    if not ok:
        print(f" --- WARNING: dp3d positivity violated (min {mn:.3e})")

    if args.golden_check and args.init == "analytic" and not args.leapfrog:
        from .golden import golden_caar

        gold = golden_caar()
        host = lambda x: x[c.np1, 0].double().cpu().numpy()
        t_diff = float(np.max(np.abs(host(state.t) - gold["T"])))
        u_diff = float(np.max(np.abs(host(state.u) - gold["v1"])))
        v_diff = float(np.max(np.abs(host(state.v) - gold["v2"])))
        print(f" --- golden diffs: T {t_diff:.3e}  u {u_diff:.3e}  v {v_diff:.3e}")

    gps = nelem * cfg.nlev * 16 * args.num_exec / wall
    print(f" ---> compute_and_apply_rhs execution total time: {wall:.9f} s "
          f"({gps/1e6:.1f} Mgridpoints/s, {dev.type})")

    if args.dump_res == "yes":
        for p in dump_results(state, c):
            print(f" --- dumped {p}")
    if args.timing_file:
        timers.summary(args.timing_file)
        print(f" --- timing summary written to {args.timing_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
