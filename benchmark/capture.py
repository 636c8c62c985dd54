"""Copies of the timed path's outputs for the correctness check, taken
without waiting for the device.

At each position the check reads (the initial state, the first step, and
the state a sampled step of the window reads and the states it and the
next step write) the whole stacked state, every tracer's rows, the
accumulators and phi are copied into device buffers made before the
program's set-up. Each copy is queued on the stream that runs the steps,
so it holds the value at that point of the chain (the accumulators
advance in place later) and the stream never stops for it. The buffers
live through set-up and the window, so the process's memory peak is
theirs plus the program's own.
"""
from __future__ import annotations

import torch


class Captures:
    def __init__(self, device: torch.device, layout: dict, ncols: int):
        """``layout``: capture key -> {array name: rows} ([rows, ncols]
        float32 each)."""
        before = _allocated(device)
        self.buffers = {
            key: {name: torch.empty((rows, ncols), dtype=torch.float32,
                                    device=device)
                  for name, rows in arrays.items()}
            for key, arrays in layout.items()}
        self.nbytes = _allocated(device) - before
        self.taken = set()

    def take(self, key: str, arrays: dict) -> None:
        """Queue the copy of ``arrays`` (name -> tensor, views allowed)
        into the buffers of ``key``."""
        bufs = self.buffers[key]
        if set(arrays) != set(bufs):
            raise ValueError(f"capture {key}: {sorted(arrays)} for "
                             f"{sorted(bufs)}")
        for name, x in arrays.items():
            bufs[name].copy_(x)
        self.taken.add(key)

    def taken_buffers(self) -> dict:
        return {k: v for k, v in self.buffers.items() if k in self.taken}


def _allocated(device: torch.device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" \
        else 0


def layout(nlev: int, qsize: int) -> dict:
    """The arrays each capture holds: phi where a step wrote it."""
    state = {"s": 4 * nlev, "qdp": qsize * nlev, "vn0u": nlev,
             "vn0v": nlev, "omg": nlev}
    return {"start": state, "first": {**state, "phi": nlev}, "in": state,
            "out": {**state, "phi": nlev}, "out2": {**state, "phi": nlev}}


def state_arrays(s, qdp, acc, phi) -> dict:
    """The arrays a capture takes (phi where the step wrote one)."""
    out = {"s": s, "qdp": qdp}
    out.update(zip(("vn0u", "vn0v", "omg"), acc))
    if phi is not None:
        out["phi"] = phi
    return out
