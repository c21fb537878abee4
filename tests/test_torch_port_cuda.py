"""The PyTorch port's CUDA kernel on the card: ``csr_segment_sum_count``
against its plain PyTorch version, its input checks and its launch count.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and skips
without one. This file imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX). Tolerance: the kernel
adds each run in edge order, the plain version through ``index_add_``, so
sums may differ in f32 rounding: max abs diff <= 1e-5 x max|sum|. Counts
are exact."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hydragnn_tpu_torch.graphs.csr import build_row_ptr
from hydragnn_tpu_torch.ops import csr_segment

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _case(dev, e, n, f, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, max(n - 1, 1), e)).astype(np.int32)
    row_ptr = torch.from_numpy(build_row_ptr(ids, n)).to(dev)
    data = torch.from_numpy(rng.normal(size=(e, f)).astype(np.float32)).to(dev)
    return data, row_ptr


@pytest.mark.parametrize("f", [1, 3, 4, 33, 64, 128, 256])
@pytest.mark.parametrize("e,n", [(5000, 1200), (40, 300), (0, 17), (20000, 40)])
def pytest_kernel_matches_plain(dev, e, n, f):
    data, row_ptr = _case(dev, e, n, f, seed=f + n)
    want_s, want_c = csr_segment.csr_segment_sum_count_plain(data, row_ptr, n)
    got_s, got_c = csr_segment.csr_segment_sum_count(data, row_ptr, n)
    torch.cuda.synchronize()
    assert got_s.shape == (n, f) and got_c.shape == (n,)
    scale = float(want_s.abs().max()) if want_s.numel() else 0.0
    assert float((got_s - want_s).abs().max()) <= 1e-5 * scale
    assert torch.equal(got_c, want_c)
    again, _ = csr_segment.csr_segment_sum_count(data, row_ptr, n)
    assert torch.equal(again, got_s)


def pytest_kernel_counts_launches_and_unaligned_rows(dev):
    data, row_ptr = _case(dev, 3000, 500, 64, seed=1)
    unaligned = torch.empty(3000 * 64 + 1, device=dev)[1:].view(3000, 64)
    unaligned.copy_(data)
    before = csr_segment.KERNEL_LAUNCHES
    a, _ = csr_segment.csr_segment_sum_count(data, row_ptr, 500)
    b, _ = csr_segment.csr_segment_sum_count(unaligned, row_ptr, 500)
    torch.cuda.synchronize()
    assert csr_segment.KERNEL_LAUNCHES == before + 2
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


@pytest.mark.parametrize("bad", ["cpu_ptr", "double", "int64_ptr"])
def pytest_kernel_rejects_bad_inputs(dev, bad):
    data, row_ptr = _case(dev, 100, 20, 8, seed=2)
    if bad == "cpu_ptr":
        row_ptr = row_ptr.cpu()
    elif bad == "double":
        data = data.double()
    else:
        row_ptr = row_ptr.long()
    before = csr_segment.KERNEL_LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        csr_segment.csr_segment_sum_count(data, row_ptr, 20)
    assert csr_segment.KERNEL_LAUNCHES == before
