"""Kahan-compensated norms + result dumps (validation tooling; counterpart
of ``tinman_sandbox_tpu/ops/norms.py``).

  * compute_norm — Kahan-summation L2 norm (utils_mod.F90:10-33);
  * print_results_2norm — pre/post norm report (main.F90:168-194);
  * dump_results_to_file — per-element text dumps for offline diff
    (cxx/basic/compute_and_apply_rhs.cpp:395-481).

The norms are host-side float64 computations: tensors are copied to the
host first.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["kahan_norm", "state_norms", "print_results_2norm", "dump_results"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def kahan_norm(x) -> float:
    """L2 norm with Kahan-compensated summation of squares in f64, exactly
    the reference's loop order (flattened C order)."""
    s = 0.0
    c = 0.0
    for v in _host(x).reshape(-1):
        y = v * v - c
        t = s + y
        c = (t - s) - y
        s = t
    return float(np.sqrt(s))


def _fast_norm(x) -> float:
    """f64 pairwise-summation norm (numpy), for arrays where the scalar Kahan
    loop would be slow."""
    flat = _host(x).reshape(-1)
    return float(np.sqrt(np.sum(flat * flat)))


def state_norms(state, exact: bool | None = None) -> dict:
    """{'v': ||u,v||, 'T': ||T||, 'dp': ||dp3d||} over all time levels.

    ``exact=None`` uses the scalar Kahan loop up to 200k values and numpy's
    f64 pairwise summation above that; ``exact=True`` forces Kahan,
    ``exact=False`` forces pairwise."""
    u, v = _host(state.u), _host(state.v)
    norm = kahan_norm if (exact or (exact is None and u.size <= 200_000)) \
        else _fast_norm
    return {
        "v": norm(np.stack([u, v])),
        "T": norm(state.t),
        "dp": norm(state.dp3d),
    }


def print_results_2norm(state, label: str = "", exact: bool | None = None) -> dict:
    n = state_norms(state, exact=exact)
    print(f" --- {label} norms:")
    print(f"          ||v||_2  = {n['v']:.12f}")
    print(f"          ||T||_2  = {n['T']:.12f}")
    print(f"          ||dp||_2 = {n['dp']:.12f}")
    return n


def dump_results(state, cfg, outdir: str = ".") -> list:
    """Write elem_state_{vx,vy,t,dp3d}.txt: one line per value with element/
    level indices (cxx/basic/compute_and_apply_rhs.cpp:395-481)."""
    os.makedirs(outdir, exist_ok=True)
    fields = {"vx": state.u, "vy": state.v, "t": state.t, "dp3d": state.dp3d}
    written = []
    for name, arr in fields.items():
        arr = _host(arr)
        path = os.path.join(outdir, f"elem_state_{name}.txt")
        with open(path, "w") as f:
            tl, ne, nlev = arr.shape[:3]
            for t in range(tl):
                for e in range(ne):
                    for k in range(nlev):
                        vals = " ".join(f"{x:.17g}" for x in arr[t, e, k].reshape(-1))
                        f.write(f"tl={t} ie={e} k={k}: {vals}\n")
        written.append(path)
    return written
