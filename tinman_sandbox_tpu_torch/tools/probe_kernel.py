"""Roofline probes: device-memory triad bandwidth, the FP32 block-product
rate and the row CAAR kernel (counterpart of the JAX repository's
``tools/probe_kernel.py``). A tuning tool, not part of a run.

    python -m tinman_sandbox_tpu_torch.tools.probe_kernel
    python -m tinman_sandbox_tpu_torch.tools.probe_kernel --device cpu

  1. triad GB/s of the saxpby kernel (``kernels.saxpby_bandwidth_gbs``);
  2. for each of the JAX tool's five (m, k, n): the rate of the probe kernel
     (``kernels.probe_mm_cuda``: twenty chained f32 [m,k]@[k,n] products) in
     GFLOP/s = 20*2*m*k*n / t, beside its bound max(20*2mkn / 67 TFLOP/s,
     4(mk + kn + mn) / 3.35 TB/s) and the same twenty products by cuBLAS
     (``torch.addmm`` in full f32, a yardstick the port never calls);
  3. the row CAAR kernel (``kernels.caar_packed``) at 1024 x 72: ms/step,
     Mgp/s and effective GB/s (22 fields of 4 bytes a point). The JAX tool
     times two TPU block widths (eb 8, 16); that option has no counterpart,
     so this is one line.

Times come from CUDA events after a warm-up; every line names the card and
its power limit. With ``--device cpu`` the plain versions run at the
smallest shapes, and the lines say that these are CPU times of the plain
versions, not the card's. Without a card and without ``--device cpu`` the
tool raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["main"]

FP32_FLOPS_PER_S = 67e12      # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
PRODUCT_ITERS = 100           # timed calls of each product, as the JAX tool's


def _seconds(fn, iters: int, dev: torch.device) -> float:
    """Mean seconds of ``fn()`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / iters


def _cublas_chain(a: torch.Tensor, b: torch.Tensor, reps: int):
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype, device=a.device)
    for _ in range(reps):
        acc = torch.addmm(acc, a, b)
    return acc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="tinman_sandbox_tpu_torch.tools.probe_kernel",
        description="triad bandwidth, FP32 block-product rate, row CAAR")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions at the smallest shapes "
                         "(CPU times, not the card's)")
    args = ap.parse_args(argv)

    from ..bench import card_name_and_power, make_problem, run_steps
    from ..device import resolve_device
    from ..kernels.probe import (
        PROBE_REPS, PROBE_SHAPES, probe_bytes, probe_flops, probe_mm_cuda)
    from ..kernels.saxpby import saxpby_bandwidth_gbs, saxpby_cuda

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        card = card_name_and_power() or torch.cuda.get_device_name(dev)
        tag = f"[{card}]"
        # the yardstick's products in full f32, as the kernel's
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        card = None
        tag = "[CPU time of the plain version, not the card's]"
    out = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "card": card}
    print(f"device: {out['device']} {tag}")

    # 1. triad bandwidth
    if on_card:
        triad = saxpby_bandwidth_gbs(device=dev)
    else:
        x, y = torch.ones(256, 256), torch.ones(256, 256)
        secs = _seconds(lambda: saxpby_cuda(1.0, 1e-6, x, y), 10, dev)
        triad = 3 * x.numel() * 4 / secs / 1e9
    out["triad_gb_per_s"] = triad
    print(f"triad BW: {triad:.1f} GB/s {tag}")

    # 2. the FP32 block-product rate
    out["matmul"] = []
    for m, k, n in PROBE_SHAPES if on_card else PROBE_SHAPES[:1]:
        a = torch.from_numpy(np.random.default_rng(0).normal(size=(m, k))
                             .astype(np.float32)).to(dev)
        b = torch.from_numpy(np.random.default_rng(1).normal(size=(k, n))
                             .astype(np.float32)).to(dev)
        iters = PRODUCT_ITERS if on_card else 3
        secs = _seconds(lambda: probe_mm_cuda(a, b), iters, dev)
        flops = probe_flops(m, k, n)
        t_ops = flops / FP32_FLOPS_PER_S
        t_bytes = probe_bytes(m, k, n) / HBM_BYTES_PER_S
        row = {"m": m, "k": k, "n": n, "ms": secs * 1e3,
               "gflop_per_s": flops / secs / 1e9,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "cublas_ms": None}
        line = (f"matmul f32 [{m},{k}]@[{k},{n}] x{PROBE_REPS}: "
                f"{row['gflop_per_s']:.0f} GFLOP/s ({row['ms']:.4f} ms; "
                f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"{row['bound_ms'] / row['ms']:.3f} of it")
        if on_card:
            row["cublas_ms"] = _seconds(
                lambda: _cublas_chain(a, b, PROBE_REPS), iters, dev) * 1e3
            line += (f"; cuBLAS {row['cublas_ms']:.4f} ms, "
                     f"{flops / row['cublas_ms'] / 1e6:.0f} GFLOP/s")
        out["matmul"].append(row)
        print(line + f") {tag}")

    # 3. the row CAAR kernel at 1024 x 72 (16 elements on the CPU)
    nelem, nlev = (1024 if on_card else 16), 72
    const, acc = make_problem(nelem, nlev, dev, layout="row")
    secs = _seconds(lambda: run_steps(const, acc, 1, "row"),
                    50 if on_card else 2, dev)
    gp = nelem * nlev * 16
    out["caar"] = {"nelem": nelem, "nlev": nlev, "ms_per_step": secs * 1e3,
                   "mgp_per_s": gp / secs / 1e6,
                   "effective_gb_per_s": 22 * gp * 4 / secs / 1e9}
    print(f"caar row {nelem}x{nlev}: {secs * 1e3:.3f} ms/step, "
          f"{gp / secs / 1e6:.0f} Mgp/s, "
          f"{out['caar']['effective_gb_per_s']:.1f} GB/s effective {tag}")
    return out


if __name__ == "__main__":
    main()
