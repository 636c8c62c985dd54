"""Command-line driver for the CAAR step, raw or assembled on the cubed
sphere, SSPRK3 dynamics, hyperviscosity and the full model step (counterpart
of the raw, ``--ne N --dss``, ``--rk``, ``--hypervis-nu``, ``--prim`` and
``--layout`` paths of ``tinman_sandbox_tpu/cli.py``).

    python -m tinman_sandbox_tpu_torch --num-elems 1024 --num-exec 100
    python -m tinman_sandbox_tpu_torch --layout row --num-elems 1024
    python -m tinman_sandbox_tpu_torch --device cpu --kernel plain \\
        --num-elems 3 --num-exec 2 --golden-check
    python -m tinman_sandbox_tpu_torch --ne 30 --dss --leapfrog --num-exec 20
    python -m tinman_sandbox_tpu_torch --ne 30 --rk --hypervis-nu 1e15 \\
        --init random --dt 0.1 --leapfrog --num-exec 20
    python -m tinman_sandbox_tpu_torch --ne 30 --prim --hypervis-nu 1e15 \\
        --init random --dt 0.1 --num-exec 10 [--qsize 4]

``--kernel cuda`` (default) runs the packed-layout step through the CUDA
kernel wrapper; on ``--device cpu`` that wrapper runs its plain version.
``--kernel plain`` runs the array-form step and is allowed only on the CPU.
``--layout`` picks the packed layout of ``--kernel cuda``: ``t`` (default,
[nlev, E16]: ``kernels.caar_t``) or ``row`` ([E16, nlev]: ``kernels.caar.
caar``, and with ``--ne N --dss`` the row assembled step ``dist.caar_dss``,
the row kernel then the structured DSS over the stacked fields). The row
layout has no SSPRK3, hyperviscosity or full-step form: ``--layout row``
with ``--rk``, ``--prim`` or ``--hypervis-nu`` is a usage error (the JAX
CLI runs those through the field form or the ``t`` layout). The array form
of ``--kernel plain`` has no layout.
``--ne N`` puts the elements on the ne x ne x 6 cubed sphere (6*N*N of them,
its geometry in place of the analytic or random one); ``--dss`` then
assembles the updated fields every step: ``dist.caar_dss_t`` (the CAAR
kernel, then the DSS extract, fixup and sweep kernels per field) with
``--kernel cuda``, the array form ``dist.caar_dss_step`` with
``--kernel plain``. An assembled run reports how far the aliases of a shared
dof disagree at the end, which is exactly 0.
``--rk`` (needs ``--ne``, honours ``--dt``) takes one SSPRK3 step per
execution: ``dist.ssprk3_t`` (three single-state CAAR launches, each with a
fixup and a sweep that carries the Shu-Osher combination) with ``--kernel
cuda``, the field form ``timeloop.ssprk3_step`` with ``--kernel plain``. The
packed step needs a continuous state, so with ``--kernel cuda`` the initial
n0 level is projected first. ``--hypervis-nu NU`` (needs ``--ne``) applies
biharmonic hyperviscosity to the fresh level after every step:
``dist.apply_hypervis_t`` (the weak-Laplacian kernel and the DSS kernels) or
the field form ``timeloop.apply_hyperviscosity``.
``--prim`` (needs ``--ne``, honours ``--dt``, manages its own time levels:
no ``--leapfrog``) takes one full model step per execution: SSPRK3 dynamics,
hyperviscosity with ``--hypervis-nu`` inside the cadence, then SSPRK3
transport of the ``--qsize`` tracers on the new winds. With ``--kernel
cuda`` the n0 level and the tracers are projected first, the state is packed
once, ``dist.prim_step_packed_t4`` chains in the packed layout and the
result is unpacked once at the end; with ``--kernel plain`` the field form
``timeloop.prim_run_step`` runs.
``--diag`` prints the global energy and mass diagnostics
(``ops.energy_diagnostics``) of the initial and the final state.
``--checkpoint PATH.npz`` writes the final state, the derived fields, the
time levels and the step count there (``timeloop.save_checkpoint``, the JAX
package's npz format); ``--restore PATH.npz`` starts from such a file, so a
run of N steps, saved, then restored for M more equals a run of N + M steps
bit for bit. The saved time levels are those the NEXT step needs: with
``--prim`` the rotated levels (the JAX CLI saves the last step's own, from
which a resumed ``--prim`` run would start over at the stale level). A
restored state is not projected again (a step's output is continuous, and
the projection is not exact in f32). A path not ending in ``.npz`` is a
directory checkpoint, as in the JAX CLI (its orbax directories): saved by
``timeloop.save_checkpoint_dir(wait=True)`` and restored by
``timeloop.load_checkpoint_dir``, the same arrays and meta as the npz
form.
The CUDA kernel is float32 only; ``--dtype`` defaults to float32 on the card
and float64 (the oracle path) on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


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
    ap.add_argument("--ne", type=int, default=None,
                    help="cubed-sphere resolution (overrides --num-elems)")
    ap.add_argument("--dss", action="store_true",
                    help="assemble shared dofs each step (needs --ne)")
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"),
                    help="float32 on the card (default there); float64 "
                         "(default on the CPU) only with --device cpu")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kernel", default="cuda", choices=("cuda", "plain"),
                    help="cuda = packed CUDA kernel (its plain version on "
                         "CPU tensors); plain = array form, CPU only")
    ap.add_argument("--layout", default="t", choices=("t", "row"),
                    help="packed layout of --kernel cuda: t = [nlev, E16] "
                         "(default), row = [E16, nlev] (raw and --dss only)")
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
    ap.add_argument("--rk", action="store_true",
                    help="SSPRK3 step with a DSS projection per stage "
                         "(needs --ne; --dt is the step)")
    ap.add_argument("--hypervis-nu", type=float, default=0.0,
                    help="biharmonic hyperviscosity coefficient applied "
                         "after each step (0 = off; needs --ne)")
    ap.add_argument("--prim", action="store_true",
                    help="full model step: SSPRK3 dynamics + hyperviscosity "
                         "+ tracer transport (needs --ne; --dt is the step)")
    ap.add_argument("--qsize", type=int, default=1,
                    help="number of tracers")
    ap.add_argument("--diag", action="store_true",
                    help="print global energy/mass diagnostics")
    ap.add_argument("--checkpoint", default=None,
                    help="write a checkpoint here at the end (*.npz = npz "
                         "file; any other path = a directory)")
    ap.add_argument("--restore", default=None,
                    help="resume from this checkpoint (.npz or directory)")
    return ap


def _usage_error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, on in (("--dss", args.dss), ("--rk", args.rk),
                     ("--hypervis-nu", args.hypervis_nu),
                     ("--prim", args.prim)):
        if on and args.ne is None:
            return _usage_error(f"{flag} requires --ne")
    for flag, on in (("--rk", args.rk), ("--prim", args.prim),
                     ("--hypervis-nu", args.hypervis_nu)):
        if on and args.layout == "row":
            return _usage_error(f"--layout row has no {flag} form (the raw "
                                "and --dss paths); use --layout t")
    if args.prim and args.leapfrog:
        return _usage_error("--prim manages its own time-level cadence; drop "
                            "--leapfrog")
    if args.qsize < 1:
        return _usage_error("--qsize must be at least 1")
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
    from .kernels import caar, caar_array, caar_t
    from .ops.norms import dump_results, print_results_2norm
    from .profiling import Timers
    from .timeloop import check_dp3d, rotated

    dev = resolve_device(args.device)
    dtype = getattr(torch, dtype_name)
    kw = dict(dtype=dtype, device=dev)
    cs = None
    if args.ne is not None:
        from .dist import build_cubed_sphere

        cs = build_cubed_sphere(args.ne, **kw)
    nelem = args.num_elems if cs is None else cs.nelem
    cfg = Config(nelem=nelem, nlev=args.nlev, qsize=args.qsize, dt=args.dt)
    if args.init == "analytic":
        state, derived = analytic_state(cfg, **kw), analytic_derived(cfg, **kw)
    else:
        state, derived = random_state(cfg, seed=7, **kw), zero_derived(cfg, **kw)
    if cs is not None:
        geom = cs.geometry
    elif args.init == "analytic":
        geom = analytic_geometry(cfg, **kw)
    else:
        geom = random_geometry(cfg, seed=8, **kw)
    hv = analytic_hvcoord(cfg, **kw)
    timers = Timers(dev)
    timers.reset()          # the native table is the process's: this run's

    steps_done = 0
    if args.restore:
        from .timeloop import load_checkpoint, load_checkpoint_dir

        load = (load_checkpoint if args.restore.endswith(".npz")
                else load_checkpoint_dir)
        state, derived, cfg, steps_done = load(args.restore, cfg, device=dev)
        state, derived = state.to(dtype=dtype), derived.to(dtype=dtype)
        print(f" --- restored step {steps_done} from {args.restore}")

    mode = "cuda" if args.kernel == "cuda" else "plain array-form"
    if args.kernel == "cuda" and args.layout == "row":
        mode += " row-layout"
    if args.prim:
        mode += " prim (SSPRK3 + tracers)"
    elif args.rk:
        mode += " SSPRK3"
    if args.dss or args.rk or args.prim:
        mode += " + structured DSS" if args.kernel == "cuda" \
            else " + segment-sum DSS"
    if args.hypervis_nu:
        mode += " + hyperviscosity"
    if cs is not None:
        mode += f", cubed sphere ne{cs.ne}"
    print(f" --- {args.num_exec} executions on {nelem} elements x {cfg.nlev} "
          f"levels ({mode} kernel, {dtype_name}, {dev.type})")
    if args.kernel == "cuda" and dev.type == "cpu":
        print(" --- cuda kernel on CPU tensors: its plain version runs")
    print_results_2norm(state, "Initial")

    dt2 = 1.0 if args.init == "analytic" else args.dt
    eta = 1.0
    if cs is not None and args.kernel == "cuda":
        from .dist import make_structured_plan

        plan = make_structured_plan(cs.gdof, cs.ne)
    finalize = None
    if (args.rk or args.prim) and args.kernel == "cuda" and not args.restore:
        from .dist import dss_project

        # the packed steps pull the projection inside the Shu-Osher
        # combinations, exact only for a continuous start
        def proj(x, level):
            out = x.clone()
            out[level] = dss_project(x[level], cs.gdof, cs.ndof,
                                     geom.spheremp, geom.rspheremp)
            return out

        state = dataclasses.replace(
            state, u=proj(state.u, cfg.n0), v=proj(state.v, cfg.n0),
            t=proj(state.t, cfg.n0), dp3d=proj(state.dp3d, cfg.n0),
            qdp=proj(state.qdp, cfg.qn0) if args.prim else state.qdp)
        print(" --- initial n0 level projected onto the continuous space"
              + (" (tracers too)" if args.prim else ""))
    if args.prim and args.kernel == "cuda":
        from .dist import prim_pack_t, prim_step_packed_t4, prim_unpack_t

        pk = prim_pack_t(state, derived, geom, hv, cfg, args.dt)
        chain = dict(s=pk["s0"], q=pk["qdp"], acc=pk["acc"], phi=None)

        def one_step(s, d, c):
            # chained in the packed layout; unpacked once at the end
            s1, q1, phi, *acc = prim_step_packed_t4(
                pk["scal"], pk["meta"], chain["s"], chain["q"], pk["pecnd"],
                *chain["acc"], pk["dvv"], plan, pk["rsp"], args.hypervis_nu,
                cfg.nlev, dt=args.dt)
            chain.update(s=s1, q=q1, acc=tuple(acc), phi=phi)
            return s, d

        def finalize(s, d):
            return prim_unpack_t(s, d, cfg, chain["s"], chain["q"],
                                 chain["phi"], chain["acc"])
    elif args.prim:
        from .timeloop import prim_run_step

        # prim_run_step returns the rotated cfg; the freshest level after
        # the loop is the np1 of the cfg the LAST step used
        prim_cfg = {"c": cfg, "used": cfg}

        def one_step(s, d, c):
            prim_cfg["used"] = prim_cfg["c"]
            s, d, prim_cfg["c"] = prim_run_step(
                s, d, geom, hv, prim_cfg["c"], cs.gdof, cs.ndof,
                nu=args.hypervis_nu, device=dev)
            return s, d
    elif args.rk and args.kernel == "cuda":
        from .dist import ssprk3_t

        # RK is a real integration: it always honours --dt
        def one_step(s, d, c):
            return ssprk3_t(s, d, geom, hv, plan, c, args.dt, device=dev)
    elif args.rk:
        from .timeloop import ssprk3_step

        def one_step(s, d, c):
            return ssprk3_step(s, d, geom, hv, c, args.dt, gdof=cs.gdof,
                               ndof=cs.ndof, device=dev)
    elif args.dss and args.kernel == "cuda":
        from .dist import caar_dss, caar_dss_t

        assemble = caar_dss if args.layout == "row" else caar_dss_t

        def one_step(s, d, c):
            return assemble(s, d, geom, hv, plan, c, dt2, eta, device=dev)
    elif args.dss:
        from .dist import caar_dss_step

        def one_step(s, d, c):
            return caar_dss_step(s, d, geom, hv, cs.gdof, cs.ndof, c, dt2,
                                 eta, device=dev)
    else:
        step = caar_array if args.kernel == "plain" else \
            caar if args.layout == "row" else caar_t

        def one_step(s, d, c):
            return step(s, d, geom, hv, c, dt2, eta, device=dev)

    # --prim applies hyperviscosity inside its cadence
    damp_on = bool(args.hypervis_nu) and not args.prim
    if damp_on and args.kernel == "cuda":
        from .dist import apply_hypervis_t

        def damp(s, c):
            return apply_hypervis_t(s, geom, plan, c, args.hypervis_nu,
                                    dt=args.dt, device=dev)
    elif damp_on:
        from .timeloop import apply_hyperviscosity

        def damp(s, c):
            return apply_hyperviscosity(s, geom, cs.gdof, cs.ndof, c,
                                        args.hypervis_nu, dt=args.dt,
                                        device=dev)

    if args.diag:
        from .ops.diagnostics import energy_diagnostics

        d0 = energy_diagnostics(state, geom.spheremp, cfg)
        print(" --- initial diagnostics: " + "  ".join(
            f"{k}={float(v):.6e}" for k, v in d0.items()))

    if finalize is not None:
        # the warm-up must not advance the chain (the kernel updates the
        # accumulators in place)
        chain0 = dict(chain, acc=tuple(a.clone() for a in chain["acc"]))
    warm = one_step(state, derived, cfg)    # warm-up (first build), excluded
    if damp_on:
        damp(warm[0], cfg)
    if finalize is not None:
        chain.update(chain0)
    elif args.prim:
        prim_cfg["c"] = prim_cfg["used"] = cfg
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    timers.start("main loop")
    t0 = time.perf_counter()
    c = cfg
    for _ in range(args.num_exec):
        with timers.region("caar compute"):
            state, derived = one_step(state, derived, c)
        if damp_on:
            with timers.region("hyperviscosity"):
                state = damp(state, c)
        if args.leapfrog:
            c = rotated(c)
    if finalize is not None:
        state, derived = finalize(state, derived)
    elif args.prim:
        c = prim_cfg["used"]
    timers.stop("main loop")
    wall = time.perf_counter() - t0
    steps_done += args.num_exec

    if args.diag:
        d1 = energy_diagnostics(state, geom.spheremp, cfg,
                                tl=c.n0 if args.leapfrog else c.np1)
        print(" --- final diagnostics:   " + "  ".join(
            f"{k}={float(v):.6e}" for k, v in d1.items()))

    print_results_2norm(state, "Final")
    # after the final rotation the freshest level is c.n0, not c.np1
    c_chk = dataclasses.replace(c, np1=c.n0) if args.leapfrog else c
    ok, mn = check_dp3d(state, c_chk)
    if not ok:
        print(f" --- WARNING: dp3d positivity violated (min {mn:.3e})")
    fresh = [getattr(state, n)[c_chk.np1] for n in ("u", "v", "t", "dp3d")]
    if not all(bool(torch.isfinite(x).all()) for x in fresh):
        print(" --- WARNING: non-finite prognostic state")
    if args.dss or args.rk or args.prim:
        from .dist import continuity_error_t
        from .kernels.layout import pack_field_t

        spread = max(continuity_error_t(pack_field_t(x), cs.gdof)
                     for x in fresh)
        print(f" --- continuity: max |alias - first alias| over u, v, T, dp "
              f"{spread:.3e}")
    if args.prim:
        from .convert import pack_qdp_t

        # the last step wrote the tracers into qdp level 1 - qn0
        q = pack_qdp_t(state, dataclasses.replace(c, qn0=1 - c.qn0))
        if not bool(torch.isfinite(q).all()):
            print(" --- WARNING: non-finite tracers")
        print(f" --- tracers: {cfg.qsize} x qdp, continuity "
              f"{continuity_error_t(q, cs.gdof):.3e}, min {float(q.min()):.6e}")

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
    if args.checkpoint:
        from .timeloop import save_checkpoint, save_checkpoint_dir

        # the levels the next step reads: --prim's last step wrote np1 and
        # tracer level 1 - qn0
        c_next = dataclasses.replace(rotated(c), qn0=1 - c.qn0) \
            if args.prim else c
        if args.checkpoint.endswith(".npz"):
            save_checkpoint(args.checkpoint, state, derived, c_next,
                            steps_done)
        else:
            save_checkpoint_dir(args.checkpoint, state, derived, c_next,
                                steps_done, wait=True)
        print(f" --- checkpoint written to {args.checkpoint}")
    if args.timing_file:
        timers.summary(args.timing_file)
        print(f" --- timing summary written to {args.timing_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
