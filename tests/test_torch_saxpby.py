"""The saxpby triad's plain version and its wrapper's checks."""
import numpy as np
import pytest
import torch

from tinman_sandbox_tpu_torch.kernels.saxpby import (
    saxpby_bandwidth_gbs,
    saxpby_cuda,
    saxpby_plain,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_saxpby_plain_matches_triad(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256, 96))).to(dtype)
    y = torch.from_numpy(rng.normal(size=(256, 96))).to(dtype)
    torch.testing.assert_close(saxpby_plain(3.0, 5.0, x, y), x * 3.0 + y * 5.0,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_saxpby_wrapper_cpu_is_in_place(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(128, 40))).to(dtype)
    y = torch.from_numpy(rng.normal(size=(128, 40))).to(dtype)
    want = x * 2.0 + y * -0.5
    launches = saxpby_cuda.launches
    out = saxpby_cuda(2.0, -0.5, x, y)
    assert out is x
    assert saxpby_cuda.launches == launches       # CPU tensors launch nothing
    torch.testing.assert_close(x, want, rtol=0, atol=0)


def test_torch_saxpby_wrapper_rejects_bad_operands():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        saxpby_cuda(1.0, 1.0, x, torch.zeros(8, 4))
    with pytest.raises(TypeError):
        saxpby_cuda(1.0, 1.0, x, torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(TypeError):
        saxpby_cuda(1.0, 1.0, x.int(), torch.zeros(8, 8).int())
    with pytest.raises(ValueError):
        saxpby_cuda(1.0, 1.0, torch.zeros(8, 16)[:, ::2], x)


def test_torch_saxpby_bandwidth_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        saxpby_bandwidth_gbs(rows=8, cols=8)
