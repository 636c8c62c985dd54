"""Copies of the timed path's outputs for the correctness check, in host
memory and taken outside timed time.

At each position the check reads (the initial state, the first step, and
the state a sampled step of the window reads and the states it and the
next step write) the whole stacked state, every tracer's rows, the
accumulators and phi are copied to host buffers: ``start`` and ``first``
in set-up, the sampled period while the window is paused (``run.py``).
Nothing of the check lives on the card while the program runs, so the
process's device memory peak is the program's own.

The buffers are made when set-up starts. Those of ``start`` and ``first``
are written through once by a thread of their own, so that the kernel
maps their pages while the program sets up rather than inside the copy
(a first-touch copy of ne120's 17 GB took ~8 s on the H100's host, a copy
into mapped pages ~2.2 s); ``take`` waits for its key's pages, and
``wait``, called before the window opens, for the thread, which so never
runs inside the window. The paused period's buffers are mapped by their
own copies, inside the pause. The buffers stay pageable: pinning one
(``cudaHostRegister``) took ~11 s, more than the copies it speeds up.
"""
from __future__ import annotations

import threading
import time

import torch


# the keys taken in set-up, mapped ahead of their copies
EARLY = ("start", "first")


class Captures:
    def __init__(self, layout: dict, ncols: int, device: torch.device):
        """``layout``: capture key -> {array name: rows} ([rows, ncols]
        float32 each)."""
        self.layout, self.device = layout, device
        self.buffers = {key: {name: torch.empty((rows, ncols),
                                                dtype=torch.float32)
                              for name, rows in arrays.items()}
                        for key, arrays in layout.items()}
        self.seconds = {}           # key -> seconds its take waited and took
        self._mapped = {key: threading.Event() for key in layout}
        for key in layout:
            if key not in EARLY:
                self._mapped[key].set()
        self._thread = threading.Thread(target=self._map, daemon=True)
        self._thread.start()

    def _map(self) -> None:
        for key in EARLY:
            for buf in self.buffers[key].values():
                buf.zero_()
            self._mapped[key].set()

    def wait(self) -> None:
        """Wait until the thread has mapped its buffers."""
        self._thread.join()

    def take(self, key: str, arrays: dict) -> None:
        """Copy ``arrays`` (name -> tensor on the device, views allowed)
        into the host buffers of ``key``, and wait until they hold it."""
        t0 = time.perf_counter()
        if set(arrays) != set(self.layout[key]):
            raise ValueError(f"capture {key}: {sorted(arrays)} for "
                             f"{sorted(self.layout[key])}")
        self._mapped[key].wait()
        for name, x in arrays.items():
            self.buffers[key][name].copy_(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[key] = time.perf_counter() - t0

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for bufs in self.buffers.values()
                   for b in bufs.values())


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
