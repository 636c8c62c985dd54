"""saxpby triad x <- a*x + b*y (counterpart of
``tinman_sandbox_tpu/kernels/saxpby.py``): the reference's bandwidth probe
and the port bench's bandwidth yardstick.

The kernel is ``csrc/saxpby.cu`` (replaces the Pallas ``saxpby``,
``kernels/saxpby.py:24`` of the JAX package). It is bound by device-memory
traffic, 2 reads and 1 write per element, and uses 16-byte vector loads in
a grid-stride loop (see the source's note). ``saxpby_plain`` is the same
function in plain PyTorch; the wrapper runs it only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["saxpby_plain", "saxpby_cuda", "saxpby_bandwidth_gbs"]


def saxpby_plain(a: float, b: float, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """a*x + b*y as a new tensor (each product and the sum rounded once)."""
    return x * a + y * b


def saxpby_cuda(a: float, b: float, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """x <- a*x + b*y in place; returns x. x and y: same shape, float32 or
    float64, contiguous. CPU tensors take ``saxpby_plain``; CUDA tensors
    launch the kernel (counted in ``saxpby_cuda.launches``)."""
    if x.shape != y.shape:
        raise ValueError(f"saxpby: shapes differ {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"saxpby: needs float32 or float64 pairs, got "
                        f"{x.dtype}/{y.dtype}")
    if x.device != y.device:
        raise ValueError(f"saxpby: devices differ {x.device} vs {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("saxpby: x and y must be contiguous")
    if x.device.type == "cpu":
        return x.copy_(saxpby_plain(a, b, x, y))
    if x.device.type != "cuda":
        raise ValueError(f"saxpby: unsupported device {x.device}")
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("saxpby: the kernel needs 16-byte aligned buffers")
    lib = _build.library("saxpby")
    fn = lib.saxpby_f32_launch if x.dtype == torch.float32 \
        else lib.saxpby_f64_launch
    err = fn(float(a), float(b), x.data_ptr(), y.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream, x.device.index)
    _build.check_launch("saxpby", err)
    saxpby_cuda.launches += 1
    return x


saxpby_cuda.launches = 0


def saxpby_bandwidth_gbs(rows: int = 8192, cols: int = 4096, iters: int = 50,
                         dtype=torch.float32, device="cuda") -> float:
    """Measured triad bandwidth of the kernel in GB/s (3 accesses per
    element), timed with CUDA events. A measurement of the card: raises
    without one."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("saxpby_bandwidth_gbs measures the card; no CUDA "
                           "device is available")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, cols, generator=gen, device=dev, dtype=dtype)
    y = torch.randn(rows, cols, generator=gen, device=dev, dtype=dtype)
    saxpby_cuda(1.0, 0.0, x, y)                 # warm-up (and first build)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        saxpby_cuda(1.0, 1e-6, x, y)
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3
    nbytes = 3 * rows * cols * x.element_size() * iters
    return nbytes / seconds / 1e9
