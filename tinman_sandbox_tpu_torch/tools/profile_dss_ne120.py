"""Stage breakdown of the assembled step at ne120 on the card (counterpart of
the JAX repository's ``tools/profile_dss_ne120.py``).

    python -m tinman_sandbox_tpu_torch.tools.profile_dss_ne120 [--ne 120] \
        [--nlev 72] [--nexec 8]
    python -m tinman_sandbox_tpu_torch.tools.profile_dss_ne120 --device cpu \
        --ne 2 --nlev 4 --nexec 1

The stages of ``profile_dss`` at the ne120 class (86,400 elements), one
JSON line a stage under the JAX tool's names: ``kernel_t4`` (the CAAR
kernel with the slab, chained), ``full_step`` (the assembled step
``caar_dss_structured_packed_t4``, chained), ``c_sweep`` (the sweep with a
zero fixup buffer) and ``c_fixup`` (extract and fixup). ``full_dense`` (the
JAX step with ``compact=False``) is ``"not applicable"``: the port has one
fixup, the compact one.

The problem is the bench's (``bench.make_assembled_problem(ne, nlev)``:
from ``bench.DIRECT_NELEM`` elements on drawn on the card by
``random_packed_problem_t`` with the sphere's metric rows, seed 7; the
unpacked [tl, 86400, 72, 4, 4] state is never made; two-float rspheremp),
as the JAX tool draws its problem on the device. Times as ``profile_dss``
(``profiling.stage_time``); the last line holds the build seconds of the
sphere and the problem and the peak device memory. The tool runs on the
card; ``--device cpu`` runs the plain versions with wall-clock times.
Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

__all__ = ["problem", "main", "RENAME", "NOT_APPLICABLE"]

# profile_dss's stages under this tool's (the JAX ne120 tool's) names
RENAME = {"kernel_t4": "kernel_t4", "full_step_t4": "full_step",
          "sweep_only": "c_sweep", "extract+fixup": "c_fixup"}
NOT_APPLICABLE = {
    "full_dense": "not applicable: the assembled step with compact=False "
                  "(the tile-dense fixup buffer) is a TPU form; the port has "
                  "one fixup, the compact one"}


def problem(ne: int, nlev: int, device):
    """``bench.make_assembled_problem`` at ne (seed 7): (const, s0, sm1,
    acc, plan, rsp, seconds) with const = (scal, meta, qdp, pecnd, dvv)
    and the seconds of the sphere's build and of the problem's."""
    from ..bench import make_assembled_problem
    from ..dist import build_cubed_sphere

    t0 = time.perf_counter()
    cs = build_cubed_sphere(ne, dtype=torch.float32, device=device)
    t1 = time.perf_counter()
    const, (s0, sm1), acc, plan, rsp = make_assembled_problem(
        ne, nlev, device, cs=cs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (const, s0, sm1, acc, plan, rsp,
            {"sphere_s": t1 - t0, "problem_s": time.perf_counter() - t1})


def run(args) -> list:
    """Every line the tool prints, as dicts."""
    from ..bench import card_name_and_power
    from ..device import resolve_device
    from .profile_dss import stages
    from .profile_prim import time_stages

    dev = resolve_device(args.device)
    card = card_name_and_power() if dev.type == "cuda" else None
    const, s0, sm1, acc, plan, rsp, secs = problem(args.ne, args.nlev, dev)
    lines = time_stages(stages(const, s0, sm1, acc, plan, rsp, names=RENAME),
                        args.nexec, dev, card, rename=RENAME)
    for name, why in NOT_APPLICABLE.items():
        lines.append({name: why})
    lines.append({"ne": args.ne, "nlev": args.nlev, "nexec": args.nexec,
                  "nelem": 6 * args.ne ** 2, **secs, "backend": dev.type,
                  "card": card,
                  "peak_device_bytes": torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else None})
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.profile_dss_ne120",
        description="the assembled step's stages timed apart at ne120")
    ap.add_argument("--ne", type=int, default=120)
    ap.add_argument("--nlev", type=int, default=72)
    ap.add_argument("--nexec", type=int, default=8,
                    help="chained calls a timed run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions, wall-clock times")
    args = ap.parse_args(argv)
    lines = run(args)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
