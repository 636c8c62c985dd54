"""The compute-rate probe's chained FP32 product (counterpart of the
``mm_kernel`` of ``tools/probe_kernel.py::main`` in the JAX repository).

    o = sum over r = 1..reps of a @ b,   a [m, k], b [k, n], o [m, n], f32

Each repetition is a full f32 product added into the accumulator
(acc = acc + a @ b), not ``reps * (a @ b)``: that would be another rounding
and a twentieth of the work the probe exists to time.

  * ``probe_mm_plain``: the same function in PyTorch, ``torch.matmul`` in
    full f32 (TF32 off, which it states and sets).
  * ``probe_mm_cuda``: the hand-written kernel of ``csrc/probe.cu`` (a
    register-tiled FP32-FFMA product fed by cp.async, a thread-block cluster
    splitting k where the output tiles are fewer than the SMs, the
    repetitions the outer loop; the source's note gives its design and
    bound), launched by the plan of ``probe_plan``. CPU tensors take
    ``probe_mm_plain``; CUDA tensors launch the kernel or raise. Launches
    are counted in ``probe_mm_cuda.launches``.
  * ``probe_plan(m, k, n)``: the launch plan (``ProbePlan``) of a shape, a
    pure function of the shape.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build

__all__ = ["PROBE_SHAPES", "PROBE_REPS", "ProbePlan", "probe_plan",
           "probe_mm_plain", "probe_mm_cuda", "probe_occupancy",
           "probe_flops", "probe_bytes"]

# the JAX tool's (m, k, n): the CAAR kernel's inner block shapes, then
# square products large enough to fill the card
PROBE_SHAPES = ((128, 128, 72), (256, 256, 72), (256, 256, 128),
                (512, 512, 512), (1024, 1024, 1024))
PROBE_REPS = 20

# the card and the kernel the plan is for: the H100's SMs and the dynamic
# shared memory a block may use; csrc/probe.cu's k-step, A^T row padding,
# pipeline stages and largest cluster
SMS = 132
SMEM_MAX = 232448
STEP = 16
PAD_A = 4
STAGES = 3
CLUSTER_MAX = 8


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """The launch of one probe product: output tiles of ``tm`` x ``tn``
    (``threads`` a block, an 8 x 8 micro-tile a thread), clusters of
    ``ksplit`` CTAs each taking a k range of ``kc`` (``k_ranges``), and
    either the k-steps ``resident`` in shared memory for all repetitions or
    a pipeline of ``stages`` k-steps; ``smem`` bytes of dynamic shared
    memory a block."""

    m: int
    k: int
    n: int
    tm: int
    tn: int
    ksplit: int
    kc: int
    resident: bool
    stages: int
    smem: int

    @property
    def threads(self) -> int:
        return self.tm * self.tn // 64

    @property
    def grid(self) -> tuple:
        return (-(-self.n // self.tn), -(-self.m // self.tm), self.ksplit)

    @property
    def ctas(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def k_ranges(self) -> list:
        """[lo, hi) of each cluster rank, in rank order."""
        return [(q * self.kc, min(self.k, (q + 1) * self.kc))
                for q in range(self.ksplit)]


# the block tiles of csrc/probe.cu; a plan takes the first that gives every
# SM a CTA with its output tiles split over clusters of 8
TILES = ((128, 64), (64, 64))


def _smem(tm: int, tn: int, ksplit: int, steps: int) -> int:
    """Bytes of csrc/probe.cu's dynamic shared memory: ``steps`` k-steps of
    A^T and B panels, and at least the tile for a cluster's sum."""
    floats = steps * STEP * (tm + PAD_A + tn)
    return 4 * max(floats, tm * tn if ksplit > 1 else 0)


def probe_plan(m: int, k: int, n: int) -> ProbePlan:
    """The launch plan of the probe product at (m, k, n): the first tile of
    ``TILES`` whose output tiles, split over clusters of 8, give every SM a
    CTA (else the last); the k range split over the smallest cluster (a
    power of two up to 8, every rank's range at least one k-step) that
    brings the CTAs to the SMs' count, and larger where that lets two blocks
    an SM hold their ranks' k-steps resident in shared memory; resident
    where they do, else the three-stage pipeline."""
    if min(m, k, n) < 1:
        raise ValueError(f"probe_plan: needs positive sizes, got {(m, k, n)}")
    count = lambda t: -(-m // t[0]) * -(-n // t[1])
    tm, tn = next((t for t in TILES if count(t) * CLUSTER_MAX >= SMS),
                  TILES[-1])
    splits = [s for s in (1, 2, 4, 8) if s * STEP <= max(k, STEP)]
    steps = lambda s: -(-(-(-k // s)) // STEP)       # ceil(ceil(k/s) / STEP)
    fits = lambda s: _smem(tm, tn, s, steps(s)) <= SMEM_MAX // 2
    ksplit = next((s for s in splits if count((tm, tn)) * s >= SMS),
                  splits[-1])
    if not fits(ksplit):
        ksplit = next((s for s in splits if s > ksplit and fits(s)), ksplit)
    resident = fits(ksplit)
    stages = steps(ksplit) if resident else STAGES
    return ProbePlan(m=m, k=k, n=n, tm=tm, tn=tn, ksplit=ksplit,
                     kc=-(-k // ksplit), resident=resident, stages=stages,
                     smem=_smem(tm, tn, ksplit, stages))


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
    into a new [m, n] tensor with the plan of ``probe_plan``; a and b
    contiguous f32."""
    _check(a, b, reps)
    if a.device.type == "cpu":
        return probe_mm_plain(a, b, reps)
    if a.device.type != "cuda":
        raise ValueError(f"probe_mm: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("probe_mm: a and b must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    plan = probe_plan(m, k, n)
    o = torch.empty(m, n, dtype=a.dtype, device=a.device)
    lib = _build.library("probe")
    err = lib.probe_mm_launch(a.data_ptr(), b.data_ptr(), o.data_ptr(), m, k,
                              n, reps, plan.tm, plan.tn, plan.ksplit, plan.kc,
                              int(plan.resident),
                              torch.cuda.current_stream(a.device).cuda_stream,
                              a.device.index)
    _build.check_launch("probe", err)
    probe_mm_cuda.launches += 1
    return o


probe_mm_cuda.launches = 0


def probe_occupancy(plan: ProbePlan, device) -> tuple:
    """(blocks an SM holds, clusters the card holds at once) of the plan's
    kernel on ``device``, from the CUDA occupancy API."""
    import ctypes

    device = torch.device(device)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library("probe").probe_occupancy(
        plan.m, plan.k, plan.n, plan.tm, plan.tn, plan.ksplit, plan.kc,
        int(plan.resident), device.index or 0, ctypes.byref(blocks),
        ctypes.byref(clusters))
    _build.check_launch("probe", err)
    return blocks.value, clusters.value
