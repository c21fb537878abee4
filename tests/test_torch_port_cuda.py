"""The PyTorch port's CUDA kernels on the card: ``csr_segment_sum_count``
(K1) and ``segment_sum_count`` (the unsorted-id kernel) against their plain
PyTorch versions, their gradients, input checks and launch counts.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and skips
without one. This file imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX). Tolerance: the kernels
add each segment in edge order, the plain versions through ``index_add_``,
so sums may differ in f32 rounding: max abs diff <= 1e-5 x max|sum| (K1),
and <= 1e-5 x the element's sum of |x| (the unsorted-id kernel, whose
20000-edge hub sums many terms). Counts are exact; gradients are gathers,
so they are equal."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hydragnn_tpu_torch.graphs.csr import build_row_ptr
from hydragnn_tpu_torch.ops import csr_segment
from hydragnn_tpu_torch.ops import segment_sum_count as ssc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _case(dev, e, n, f, seed, with_ids=False):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, max(n - 1, 1), e)).astype(np.int32)
    row_ptr = torch.from_numpy(build_row_ptr(ids, n)).to(dev)
    data = torch.from_numpy(rng.normal(size=(e, f)).astype(np.float32)).to(dev)
    if with_ids:
        return data, row_ptr, torch.from_numpy(ids).to(dev)
    return data, row_ptr


@pytest.mark.parametrize("f", [1, 3, 4, 33, 64, 128, 256])
@pytest.mark.parametrize("e,n", [(5000, 1200), (40, 300), (0, 17), (20000, 40)])
def pytest_kernel_matches_plain(dev, e, n, f):
    data, row_ptr = _case(dev, e, n, f, seed=f + n)
    want_s, want_c = csr_segment.csr_segment_sum_count_plain(data, row_ptr, n)
    got_s, got_c = csr_segment.csr_segment_sum_count_forward(data, row_ptr, n)
    torch.cuda.synchronize()
    assert got_s.shape == (n, f) and got_c.shape == (n,)
    scale = float(want_s.abs().max()) if want_s.numel() else 0.0
    assert float((got_s - want_s).abs().max()) <= 1e-5 * scale
    assert torch.equal(got_c, want_c)
    again, _ = csr_segment.csr_segment_sum_count_forward(data, row_ptr, n)
    assert torch.equal(again, got_s)


def pytest_kernel_counts_launches_and_unaligned_rows(dev):
    data, row_ptr = _case(dev, 3000, 500, 64, seed=1)
    unaligned = torch.empty(3000 * 64 + 1, device=dev)[1:].view(3000, 64)
    unaligned.copy_(data)
    before = csr_segment.KERNEL_LAUNCHES
    a, _ = csr_segment.csr_segment_sum_count_forward(data, row_ptr, 500)
    b, _ = csr_segment.csr_segment_sum_count_forward(unaligned, row_ptr, 500)
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
        csr_segment.csr_segment_sum_count_forward(data, row_ptr, 20)
    assert csr_segment.KERNEL_LAUNCHES == before


def pytest_kernel_gradient_matches_plain(dev):
    """K1 carries a gradient on the card: the output has a ``grad_fn`` and
    ``torch.autograd.grad`` through it equals the CPU (plain) version's, the
    gather ``d_data[e] = d_sum[ids[e]]``. Before K1 had an autograd Function
    the card's output had no ``grad_fn``, so nothing reached ``data``."""
    data, row_ptr, ids = _case(dev, 4000, 700, 64, seed=3, with_ids=True)
    weight = torch.randn(700, 64, device=dev, generator=torch.Generator(dev).manual_seed(4))
    grads = []
    for d, p, i, w in ((data, row_ptr, ids, weight),
                       (data.cpu(), row_ptr.cpu(), ids.cpu(), weight.cpu())):
        d = d.clone().requires_grad_(True)
        total, count = csr_segment.csr_segment_sum_count(d, p, i, 700)
        assert total.grad_fn is not None and not count.requires_grad
        (g,) = torch.autograd.grad((total * w).sum(), d)
        grads.append(g)
    torch.cuda.synchronize()
    assert torch.equal(grads[0].cpu(), grads[1])


def _unsorted(dev, e, n, f, seed, masked=0.3, hub=0):
    """Random unsorted ids over ``n`` segments (the last fifth left empty),
    a share ``masked`` at -1 and ``hub`` more rows all on segment 1."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(4 * n // 5, 1), e + hub).astype(np.int32)
    if hub:
        ids[rng.permutation(e + hub)[:hub]] = 1
    ids[rng.random(e + hub) < masked] = -1
    data = torch.from_numpy(rng.normal(size=(e + hub, f)).astype(np.float32)).to(dev)
    return data, torch.from_numpy(ids).to(dev)


@pytest.mark.parametrize("f", [1, 4, 33, 64, 100, 256])
@pytest.mark.parametrize(
    "e,n,hub", [(5000, 1200, 0), (40, 300, 0), (0, 17, 0), (3000, 40, 20000), (30000, 8192, 0)]
)
def pytest_unsorted_kernel_matches_plain(dev, e, n, hub, f):
    data, ids = _unsorted(dev, e, n, f, seed=f + n, hub=hub)
    want_s, want_c = ssc.segment_sum_count_plain(data, ids, n)
    bound = ssc.segment_sum_count_plain(data.abs(), ids, n)[0]
    before, wide = ssc.KERNEL_LAUNCHES, ssc.WIDE_LAUNCHES
    got_s, got_c = ssc.segment_sum_count_forward(data, ids, n)
    again, _ = ssc.segment_sum_count_forward(data, ids, n)
    torch.cuda.synchronize()
    assert ssc.KERNEL_LAUNCHES == before + 2
    assert ssc.WIDE_LAUNCHES == wide + (2 if f > ssc.WIDE_F else 0)
    assert got_s.shape == (n, f) and got_c.shape == (n,)
    assert bool(((got_s - want_s).abs() <= 1e-5 * bound).all())
    assert torch.equal(got_c, want_c)
    assert torch.equal(again, got_s)


def pytest_unsorted_kernel_edge_cases(dev):
    """Every row masked, ids past the last segment, and an unaligned data
    pointer (scalar loads) against the aligned launch."""
    data, ids = _unsorted(dev, 3000, 500, 64, seed=5)
    s, c = ssc.segment_sum_count_forward(data, torch.full_like(ids, -1), 500)
    assert not s.any() and not c.any()
    past = ids.clone()
    past[::7] = 500 + 3
    want_s, want_c = ssc.segment_sum_count_plain(data, past, 500)
    got_s, got_c = ssc.segment_sum_count_forward(data, past, 500)
    assert torch.equal(got_c, want_c)
    assert float((got_s - want_s).abs().max()) <= 1e-5 * float(want_s.abs().max())
    unaligned = torch.empty(3000 * 64 + 1, device=dev)[1:].view(3000, 64)
    unaligned.copy_(data)
    a, _ = ssc.segment_sum_count_forward(data, ids, 500)
    b, _ = ssc.segment_sum_count_forward(unaligned, ids, 500)
    torch.cuda.synchronize()
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def pytest_unsorted_kernel_gradient_matches_plain(dev):
    data, ids = _unsorted(dev, 5000, 900, 16, seed=6)
    weight = torch.randn(900, 16, device=dev, generator=torch.Generator(dev).manual_seed(7))
    grads = []
    for d, i, w in ((data, ids, weight), (data.cpu(), ids.cpu(), weight.cpu())):
        d = d.clone().requires_grad_(True)
        total, count = ssc.segment_sum_count(d, i, 900)
        assert total.grad_fn is not None and not count.requires_grad
        (g,) = torch.autograd.grad((total * w).sum(), d)
        grads.append(g)
    torch.cuda.synchronize()
    assert torch.equal(grads[0].cpu(), grads[1])


@pytest.mark.parametrize("with_ptr", [True, False], ids=["csr", "unsorted"])
def pytest_stats_gradient_matches_cpu(dev, with_ptr):
    """The PNA stats bundle's analytic backward on the card against the CPU,
    on either route: within rtol 1e-4 + atol 1e-5 x max|g| (the forward
    sums in another order)."""
    data, row_ptr, ids = _case(dev, 6000, 1000, 32, seed=8, with_ids=True)
    mask = torch.from_numpy(np.random.default_rng(9).random(6000) > 0.2).to(dev)
    grads = []
    for where in (dev, "cpu"):
        d = data.to(where).clone().requires_grad_(True)
        total, mean, std, _ = csr_segment.fused_segment_stats(
            d, ids.to(where), 1000, mask=mask.to(where),
            row_ptr=row_ptr.to(where) if with_ptr else None,
        )
        (g,) = torch.autograd.grad(total.sum() + mean.square().sum() + std.sum(), d)
        grads.append(g.cpu())
    tol = 1e-4 * grads[1].abs() + 1e-5 * float(grads[1].abs().max())
    excess = (grads[0] - grads[1]).abs() - tol
    e, c = divmod(int(excess.argmax()), excess.shape[1])
    assert float(excess.max()) <= 0.0, (
        f"row {e} (segment {int(ids[e])}, masked {not bool(mask[e])}) column {c}: card "
        f"{float(grads[0][e, c])} vs CPU {float(grads[1][e, c])}, tolerance {float(tol[e, c])}"
    )


@pytest.mark.parametrize("bad", ["cpu_ids", "double", "int64_ids", "short_ids"])
def pytest_unsorted_kernel_rejects_bad_inputs(dev, bad):
    data, ids = _unsorted(dev, 100, 20, 8, seed=2)
    if bad == "cpu_ids":
        ids = ids.cpu()
    elif bad == "double":
        data = data.double()
    elif bad == "int64_ids":
        ids = ids.long()
    else:
        ids = ids[:-1]
    before = ssc.KERNEL_LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        ssc.segment_sum_count_forward(data, ids, 20)
    assert ssc.KERNEL_LAUNCHES == before
