"""The PyTorch port's CUDA kernels on the card: ``csr_segment_sum_count``
(K1), ``csr_segment_stats_forward`` (the CSR stats kernel, K5),
``segment_sum_count`` (the unsorted-id kernel, K2/K3) and
``segment_sum_count_skip_forward`` (the block-skip kernel, K4) against
their plain PyTorch versions, their gradients, input checks and launch
counts.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and skips
without one. This file imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX). Tolerance: the kernels
add each segment in edge order, the plain versions through ``index_add_``,
so sums may differ in f32 rounding: max abs diff <= 1e-5 x max|sum| (K1),
and <= 1e-5 x the element's sum of |x| (K1's long runs, K2/K3 and K4,
whose 20000-edge hubs sum many terms); K5's sum, mean and std within
KERNEL_CERT_GATE.fwd (5e-4) of the f64 plain version, its min and max
bit-equal. Counts are exact; gradients are gathers, so they are equal.

``python tests/test_torch_port_cuda.py [runs]`` runs the stats gradient
check ``runs`` times (default 50) on each route and prints every failure
(ROADMAP C4)."""

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


def stats_gradient_excess(dev, with_ptr, seed=8):
    """The PNA stats bundle's gradient on the card (K5 with ``row_ptr``, the
    unsorted-id kernel without) against the CPU's, on inputs made from
    ``seed``: (the largest excess over rtol 1e-4 + atol 1e-5 x max|g|, a
    description of the element where it is reached: its segment, the
    segment's size, its centred value and the segment's std)."""
    data, row_ptr, ids = _case(dev, 6000, 1000, 32, seed=seed, with_ids=True)
    mask = torch.from_numpy(np.random.default_rng(seed + 1).random(6000) > 0.2).to(dev)
    grads, stats = [], []
    for where in (dev, "cpu"):
        d = data.to(where).clone().requires_grad_(True)
        total, mean, std, count = csr_segment.fused_segment_stats(
            d, ids.to(where), 1000, mask=mask.to(where),
            row_ptr=row_ptr.to(where) if with_ptr else None,
        )
        (g,) = torch.autograd.grad(total.sum() + mean.square().sum() + std.sum(), d)
        grads.append(g.cpu())
        stats.append((mean.detach().cpu(), std.detach().cpu(), count.cpu()))
    tol = 1e-4 * grads[1].abs() + 1e-5 * float(grads[1].abs().max())
    excess = (grads[0] - grads[1]).abs() - tol
    e, c = divmod(int(excess.argmax()), excess.shape[1])
    seg = int(ids[e])
    mean, std, count = stats[1]
    x = float(data[e, c]) if bool(mask[e]) else 0.0
    return float(excess.max()), (
        f"row {e} (segment {seg} of {int(count[seg])} rows, masked {not bool(mask[e])}) "
        f"column {c}: card {float(grads[0][e, c])} vs CPU {float(grads[1][e, c])}, tolerance "
        f"{float(tol[e, c])}; centred value {x - float(mean[seg, c]):.3e}, std "
        f"{float(std[seg, c]):.3e}"
    )


@pytest.mark.parametrize("with_ptr", [True, False], ids=["csr", "unsorted"])
def pytest_stats_gradient_matches_cpu(dev, with_ptr):
    """The PNA stats bundle's analytic backward on the card against the CPU,
    on either route: within rtol 1e-4 + atol 1e-5 x max|g| (the forward
    sums in another order)."""
    excess, where = stats_gradient_excess(dev, with_ptr)
    assert excess <= 0.0, where


def _runs(dev, lens, f, seed, off=3, extra=5):
    """Runs of the given lengths from row ``off`` on, ``extra`` rows after."""
    rng = np.random.default_rng(seed)
    row_ptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]) + off, dtype=torch.int32,
                           device=dev)
    e = int(row_ptr[-1]) + extra
    data = torch.from_numpy(rng.normal(size=(e, f)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(e) > 0.25).to(dev)
    return data, mask, row_ptr


# Runs on both sides of every lane-group width and piece size (a sub-group
# walks at most 32 entries of a run; longer runs are split into pieces
# merged in a tree of fan-in 16), and a 20000-entry run.
LANE_RUNS = [0, 1, 31, 32, 33, 128, 129, 0, 2, 20000, 7]


@pytest.mark.parametrize("f", [1, 2, 3, 8, 16, 32, 33, 64, 65, 128, 384])
def pytest_kernel_lane_group_shapes(dev, f):
    """K1 at every lane-group width: sums within 1e-5 x the row's sum of
    |x| (the f32 rounding bound of a 20000-term run), counts exact, two
    launches bit-identical, one launch per call."""
    data, _, row_ptr = _runs(dev, LANE_RUNS, f, seed=f)
    n = len(LANE_RUNS)
    want_s, want_c = csr_segment.csr_segment_sum_count_plain(data, row_ptr, n)
    bound = csr_segment.csr_segment_sum_count_plain(data.abs(), row_ptr, n)[0]
    before = csr_segment.KERNEL_LAUNCHES
    got_s, got_c = csr_segment.csr_segment_sum_count_forward(data, row_ptr, n)
    again, _ = csr_segment.csr_segment_sum_count_forward(data, row_ptr, n)
    torch.cuda.synchronize()
    assert csr_segment.KERNEL_LAUNCHES == before + 2
    assert bool(((got_s - want_s).abs() <= 1e-5 * bound).all())
    assert torch.equal(got_c, want_c)
    assert torch.equal(again, got_s)


KERNEL_CERT_FWD = 5e-4  # the reference's KERNEL_CERT_GATE.fwd (precision/tolerance.py)


def _k5_case(dev, case, f):
    rng = np.random.default_rng(f + len(case))
    if case == "flagship":
        data, row_ptr = _case(dev, 32768, 8192, f, seed=f)
        mask = torch.from_numpy(rng.random(32768) > 0.43).to(dev)
        return data, mask, row_ptr, 8192
    if case == "hub":
        data, mask, row_ptr = _runs(dev, [3] * 40 + [20000] + [5] * 40, f, seed=f)
        return data, mask, row_ptr, 81
    if case == "all_masked":
        data, row_ptr = _case(dev, 5000, 700, f, seed=f)
        return data, torch.zeros(5000, dtype=torch.bool, device=dev), row_ptr, 700
    if case == "half_empty":
        ids = np.sort(rng.integers(0, 4000, 30000)).astype(np.int32)
        row_ptr = torch.from_numpy(build_row_ptr(ids, 8192)).to(dev)
        data = torch.from_numpy(rng.normal(size=(30000, f)).astype(np.float32)).to(dev)
        return data, torch.from_numpy(rng.random(30000) > 0.2).to(dev), row_ptr, 8192
    data, row_ptr = _case(dev, 3000, 500, f, seed=f)  # "unaligned"
    unaligned = torch.empty(3000 * f + 1, device=dev)[1:].view(3000, f)
    unaligned.copy_(data)
    return unaligned, torch.from_numpy(rng.random(3000) > 0.2).to(dev), row_ptr, 500


@pytest.mark.parametrize("f", [1, 33, 64, 256])
@pytest.mark.parametrize("case", ["flagship", "hub", "all_masked", "half_empty", "unaligned"])
def pytest_stats_kernel_matches_plain(dev, case, f):
    """K5 against its plain version: counts, min and max bit-equal; mean
    and std within KERNEL_CERT_GATE.fwd of the f64 plain version, sums within
    the larger of that and 1e-5 x their sum of |x| (the f32 rounding bound
    of the hub's 20000-term run); two launches bit-identical; one K5 launch
    per call and no K1 launch."""
    data, mask, row_ptr, n = _k5_case(dev, case, f)
    want = csr_segment.csr_segment_stats_plain(data, mask, row_ptr, n)
    truth = csr_segment.csr_segment_stats_plain(data.double(), mask, row_ptr, n)
    k1, k5 = csr_segment.KERNEL_LAUNCHES, csr_segment.STATS_LAUNCHES
    got = csr_segment.csr_segment_stats_forward(data, mask, row_ptr, n)
    again = csr_segment.csr_segment_stats_forward(data, mask, row_ptr, n)
    torch.cuda.synchronize()
    assert (csr_segment.KERNEL_LAUNCHES, csr_segment.STATS_LAUNCHES) == (k1, k5 + 2)
    for name, a, b in zip(("count", "min", "max"), got[3:], want[3:]):
        assert torch.equal(a, b), name
    bound = csr_segment.csr_segment_sum_count_plain(data.abs().double(), row_ptr, n)[0]
    assert bool(((got[0].double() - truth[0]).abs() <= (1e-5 * bound).clamp_min(KERNEL_CERT_FWD))
                .all()), "sum"
    for name, a, b in zip(("mean", "std"), got[1:3], truth[1:3]):
        assert float((a.double() - b).abs().max()) <= KERNEL_CERT_FWD, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("f", [1, 64])
def pytest_stats_kernel_options(dev, f):
    """``want_std=False`` gives std 0 and ``want_extrema=False`` no min/max,
    with the same sums and means; no mask keeps every row."""
    data, mask, row_ptr, n = _k5_case(dev, "hub", f)
    full = csr_segment.csr_segment_stats_forward(data, None, row_ptr, n)
    bare = csr_segment.csr_segment_stats_forward(data, None, row_ptr, n, want_std=False,
                                                 want_extrema=False)
    want = csr_segment.csr_segment_stats_plain(data.double(), None, row_ptr, n)
    torch.cuda.synchronize()
    assert bare[4] is None and bare[5] is None and not bare[2].any()
    assert torch.equal(bare[0], full[0]) and torch.equal(bare[1], full[1])
    assert torch.equal(full[4], want[4].float()) and torch.equal(full[5], want[5].float())
    assert float((full[2].double() - want[2]).abs().max()) <= KERNEL_CERT_FWD


def pytest_pna_aggregate_on_k5_matches_cpu(dev):
    """PNA's bundle with CSR pointers on the card is one K5 launch and no
    K1 launch; its outputs and the gradient of ``msg`` equal the CPU's
    within rtol 1e-4 + atol 1e-5 x max|g|."""
    data, row_ptr, ids = _case(dev, 6000, 1000, 32, seed=21, with_ids=True)
    mask = torch.from_numpy(np.random.default_rng(22).random(6000) > 0.2).to(dev)
    weight = torch.from_numpy(np.random.default_rng(23).normal(size=(1000, 4, 32))
                              .astype(np.float32))
    outs, grads = [], []
    for where in (dev, "cpu"):
        d = data.to(where).clone().requires_grad_(True)
        k1, k5 = csr_segment.KERNEL_LAUNCHES, csr_segment.STATS_LAUNCHES
        agg, count = csr_segment.pna_aggregate(
            d, ids.to(where), 1000, ("mean", "min", "max", "std"), mask=mask.to(where),
            row_ptr=row_ptr.to(where))
        launched = (csr_segment.KERNEL_LAUNCHES - k1, csr_segment.STATS_LAUNCHES - k5)
        assert launched == ((0, 1) if where == dev else (0, 0))
        (g,) = torch.autograd.grad((agg * weight.to(where)).sum(), d)
        outs.append((agg.detach().cpu(), count.cpu()))
        grads.append(g.cpu())
    torch.cuda.synchronize()
    assert torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-5)
    tol = 1e-4 * grads[1].abs() + 1e-5 * float(grads[1].abs().max())
    assert bool(((grads[0] - grads[1]).abs() <= tol).all())


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


def _ascending(dev, e, n, f, seed, kept=0.6, pad_row=None):
    """Collation-like ids: ascending receivers over the first ``kept`` share
    of the rows; the rest masked (-1), or on ``pad_row`` when given (the
    padding edges of messages that pass no mask)."""
    rng = np.random.default_rng(seed)
    real = int(e * kept)
    ids = np.full(e, -1 if pad_row is None else pad_row, dtype=np.int32)
    ids[:real] = np.sort(rng.integers(0, max(n - 2, 1), real))
    data = torch.from_numpy(rng.normal(size=(e, f)).astype(np.float32)).to(dev)
    return data, torch.from_numpy(ids).to(dev)


@pytest.mark.parametrize("f", [1, 6, 33, 64, 256, 384])
@pytest.mark.parametrize(
    "case", ["ascending", "ascending_pad_row", "scattered", "masked", "hub", "tiny"]
)
def pytest_skip_kernel_matches_plain(dev, case, f):
    """K4 (the block-skip kernel) against its plain version: counts equal,
    sums within 1e-5 x each element's sum of |x|, two launches
    bit-identical, and within the same bound of K2/K3 on the same input."""
    if case == "ascending":
        data, ids = _ascending(dev, 32768, 8192, f, seed=f)
        n = 8192
    elif case == "ascending_pad_row":
        data, ids = _ascending(dev, 32768, 8192, f, seed=f, pad_row=8191)
        n = 8192
    elif case == "scattered":
        data, ids = _unsorted(dev, 5000, 1200, f, seed=f)
        n = 1200
    elif case == "masked":
        data, ids = _unsorted(dev, 3000, 500, f, seed=f, masked=1.0)
        n = 500
    elif case == "hub":
        data, ids = _unsorted(dev, 3000, 100, f, seed=f, hub=20000)
        n = 100
    else:
        data, ids = _unsorted(dev, 40, 300, f, seed=f)
        n = 300
    want_s, want_c = ssc.segment_sum_count_skip_plain(data, ids, n)
    bound = ssc.segment_sum_count_plain(data.abs(), ids, n)[0]
    before = ssc.SKIP_LAUNCHES
    got_s, got_c = ssc.segment_sum_count_skip_forward(data, ids, n)
    again_s, again_c = ssc.segment_sum_count_skip_forward(data, ids, n)
    k2_s, k2_c = ssc.segment_sum_count_forward(data, ids, n)
    torch.cuda.synchronize()
    assert ssc.SKIP_LAUNCHES == before + 2
    assert got_s.shape == (n, f) and got_c.shape == (n,)
    assert torch.equal(got_c, want_c) and torch.equal(got_c, k2_c)
    assert bool(((got_s - want_s).abs() <= 1e-5 * bound).all())
    assert bool(((got_s - k2_s).abs() <= 1e-5 * bound).all())
    assert torch.equal(again_s, got_s) and torch.equal(again_c, got_c)


def pytest_skip_kernel_edge_cases(dev):
    """Ids past the last segment, an unaligned data pointer (scalar loads),
    and no edges at all."""
    data, ids = _ascending(dev, 4000, 700, 64, seed=11, pad_row=699)
    past = ids.clone()
    past[::7] = 700 + 3
    want_s, want_c = ssc.segment_sum_count_skip_plain(data, past, 700)
    got_s, got_c = ssc.segment_sum_count_skip_forward(data, past, 700)
    assert torch.equal(got_c, want_c)
    assert float((got_s - want_s).abs().max()) <= 1e-5 * float(want_s.abs().max())
    unaligned = torch.empty(4000 * 64 + 1, device=dev)[1:].view(4000, 64)
    unaligned.copy_(data)
    a, _ = ssc.segment_sum_count_skip_forward(data, ids, 700)
    b, _ = ssc.segment_sum_count_skip_forward(unaligned, ids, 700)
    s, c = ssc.segment_sum_count_skip_forward(data[:0], ids[:0], 700)
    torch.cuda.synchronize()
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    assert not s.any() and not c.any()


def pytest_skip_switch_routes_to_k4(dev, monkeypatch):
    """Under HYDRAGNN_PALLAS_SKIP=1 the (sum, count) wrapper launches K4 and
    not K2/K3; its gradient is the gather, equal to the CPU's."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", "1")
    data, ids = _ascending(dev, 5000, 900, 16, seed=12)
    weight = torch.randn(900, 16, device=dev, generator=torch.Generator(dev).manual_seed(13))
    k2, k4 = ssc.KERNEL_LAUNCHES, ssc.SKIP_LAUNCHES
    grads = []
    for d, i, w in ((data, ids, weight), (data.cpu(), ids.cpu(), weight.cpu())):
        d = d.clone().requires_grad_(True)
        total, count = ssc.segment_sum_count(d, i, 900)
        assert total.grad_fn is not None and not count.requires_grad
        (g,) = torch.autograd.grad((total * w).sum(), d)
        grads.append(g)
    torch.cuda.synchronize()
    assert (ssc.KERNEL_LAUNCHES, ssc.SKIP_LAUNCHES) == (k2, k4 + 1)
    assert torch.equal(grads[0].cpu(), grads[1])


@pytest.mark.parametrize("bad", ["cpu_ids", "double", "int64_ids", "short_ids"])
def pytest_skip_kernel_rejects_bad_inputs(dev, bad):
    data, ids = _unsorted(dev, 100, 20, 8, seed=2)
    if bad == "cpu_ids":
        ids = ids.cpu()
    elif bad == "double":
        data = data.double()
    elif bad == "int64_ids":
        ids = ids.long()
    else:
        ids = ids[:-1]
    before = ssc.SKIP_LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        ssc.segment_sum_count_skip_forward(data, ids, 20)
    assert ssc.SKIP_LAUNCHES == before


def c4_loop(runs):
    """ROADMAP C4: :func:`stats_gradient_excess` ``runs`` times on each
    route, each run on inputs of its own seed (every kernel on the path is
    deterministic, so one input repeated is one sample), printing every
    failure's worst element and the count."""
    dev = torch.device("cuda", 0)
    for with_ptr in (True, False):
        failed = 0
        worst = float("-inf")
        for k in range(runs):
            excess, where = stats_gradient_excess(dev, with_ptr, seed=1000 + 2 * k)
            worst = max(worst, excess)
            if excess > 0.0:
                failed += 1
                print(f"C4 {'csr' if with_ptr else 'unsorted'} run {k} (seed {1000 + 2 * k}): "
                      f"excess {excess:.3e} at {where}")
        print(f"C4 {'csr' if with_ptr else 'unsorted'}: {failed} of {runs} runs failed; largest "
              f"excess over the tolerance {worst:.3e} (<= 0 passes)")


if __name__ == "__main__":
    # python tests/test_torch_port_cuda.py [runs]: the C4 loop on the card.
    c4_loop(int(sys.argv[1]) if len(sys.argv) > 1 else 50)
