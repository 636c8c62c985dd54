"""The compute-rate probe's chained FP32 product (counterpart of the
``mm_kernel`` of ``tools/probe_kernel.py::main`` in the JAX repository).

    o = sum over r = 1..reps of a @ b,   a [m, k], b [k, n], o [m, n], f32

Each repetition is a full f32 product added into the accumulator
(acc = acc + a @ b), not ``reps * (a @ b)``: that would be another rounding
and a twentieth of the work the probe exists to time.

  * ``probe_mm_plain``: the same function in PyTorch, ``torch.matmul`` in
    full f32 (TF32 off, which it states and sets).
  * ``probe_mm_cuda``: the hand-written kernel of ``csrc/probe.cu`` (a tiled
    FP32-FFMA product, the repetitions the outer loop; the source's note
    gives its design and bound). CPU tensors take ``probe_mm_plain``; CUDA
    tensors launch the kernel or raise. Launches are counted in
    ``probe_mm_cuda.launches``.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["PROBE_SHAPES", "PROBE_REPS", "probe_mm_plain", "probe_mm_cuda",
           "probe_flops", "probe_bytes"]

# the JAX tool's (m, k, n): the CAAR kernel's inner block shapes, then
# square products large enough to fill the card
PROBE_SHAPES = ((128, 128, 72), (256, 256, 72), (256, 256, 128),
                (512, 512, 512), (1024, 1024, 1024))
PROBE_REPS = 20


def probe_flops(m: int, k: int, n: int, reps: int = PROBE_REPS) -> int:
    """FP32 operations of one call: reps products of 2*m*k*n (the
    accumulator's reps*m*n adds left out, as the JAX tool counts)."""
    return reps * 2 * m * k * n


def probe_bytes(m: int, k: int, n: int) -> int:
    """Device-memory bytes of one call: a and b read once, o written once."""
    return 4 * (m * k + k * n + m * n)


def _check(a: torch.Tensor, b: torch.Tensor, reps: int):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"probe_mm: needs a [m, k] and b [k, n], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"probe_mm: needs float32, got {a.dtype}/{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"probe_mm: devices differ {a.device} vs {b.device}")
    if reps < 1:
        raise ValueError(f"probe_mm: reps must be at least 1, got {reps}")


def probe_mm_plain(a: torch.Tensor, b: torch.Tensor,
                   reps: int = PROBE_REPS) -> torch.Tensor:
    """acc = acc + a @ b, ``reps`` times from zero, in full f32."""
    _check(a, b, reps)
    # TF32 keeps about three decimal digits: the product stays full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype, device=a.device)
    for _ in range(reps):
        acc = acc + torch.matmul(a, b)
    return acc


def probe_mm_cuda(a: torch.Tensor, b: torch.Tensor,
                  reps: int = PROBE_REPS) -> torch.Tensor:
    """``probe_mm_plain``'s function, on the card by the hand-written kernel
    into a new [m, n] tensor; a and b contiguous f32."""
    _check(a, b, reps)
    if a.device.type == "cpu":
        return probe_mm_plain(a, b, reps)
    if a.device.type != "cuda":
        raise ValueError(f"probe_mm: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("probe_mm: a and b must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    o = torch.empty(m, n, dtype=a.dtype, device=a.device)
    lib = _build.library("probe")
    err = lib.probe_mm_launch(a.data_ptr(), b.data_ptr(), o.data_ptr(), m, k,
                              n, reps,
                              torch.cuda.current_stream(a.device).cuda_stream,
                              a.device.index)
    _build.check_launch("probe", err)
    probe_mm_cuda.launches += 1
    return o


probe_mm_cuda.launches = 0
