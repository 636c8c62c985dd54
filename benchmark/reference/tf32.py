"""The reference computed in TF32, the control that the check has to
refuse: under ``TF32()`` every float32 result of a torch operation is
rounded to TF32's 10-bit mantissa (round to nearest, ties to even), on any
device. Contractions therefore take TF32 operands and accumulate in
float32, as the tensor cores do, and every other operation keeps TF32's
precision.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_DROP = 13                                   # float32 has 23 mantissa bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, _DROP), 1)
    i = torch.bitwise_and(i + ((1 << (_DROP - 1)) - 1) + lsb,
                          ~((1 << _DROP) - 1))
    return i.view(torch.float32).view(x.shape)


def _rounded(out):
    if isinstance(out, torch.Tensor) and out.dtype == torch.float32:
        return round_tf32(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_rounded(o) for o in out)
    return out


class TF32(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name.endswith("_") and not name.startswith("__") \
                and isinstance(out, torch.Tensor) \
                and out.dtype == torch.float32:
            out.copy_(round_tf32(out))
            return out
        return _rounded(out)
