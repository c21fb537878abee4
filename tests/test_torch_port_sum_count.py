"""Port parity, the unsorted-id route and the segment gradients: the port's
``segment_sum_count``, the fused ops and the model on batches without CSR
pointers, and the backward of every segment reduction on the training path,
against the JAX package on the same numpy inputs, on the CPU. Here the
port's wrappers run their plain PyTorch versions; the JAX side runs its
Pallas kernels in interpret mode (``HYDRAGNN_PALLAS=1``) or its default XLA
route.

Tolerance rtol=1e-4, atol=1e-5 (f32 sums in another order). A raw segment
SUM that the JAX side took from its bf16 hi/lo Pallas kernel carries that
kernel's own error, up to 2^-16 * sum|x| per row (ROADMAP §C1): such sums
are held to the f64 truth at rtol/atol and to the JAX value within atol
plus that bound. Counts are exact. Gradients are compared at rtol/atol;
the std gradient, which that error reaches through the mean amplified by
1/(σ·n), likewise against an f64 truth and the JAX value widened by the
propagated bound (``_stats_grad_truth``)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from hydragnn_tpu.graphs import collate as jcollate
from hydragnn_tpu.ops import pallas_segment as jps

from hydragnn_tpu_torch.graphs import GraphBatch, collate_graphs
from hydragnn_tpu_torch.graphs.csr import build_row_ptr
from hydragnn_tpu_torch.ops import csr_segment as tcs
from hydragnn_tpu_torch.ops import segment_sum_count as ssc

from test_torch_port_model import (
    CONFIGS,
    assert_outputs_close,
    jax_model_and_variables,
    make_graphs,
    port_model,
    to_jax_samples,
)

RTOL, ATOL = 1e-4, 1e-5


def _route(monkeypatch, pallas):
    monkeypatch.delenv("HYDRAGNN_SEGMENT_SORTED", raising=False)
    monkeypatch.delenv("HYDRAGNN_PALLAS_CSR", raising=False)
    if pallas:
        monkeypatch.setenv("HYDRAGNN_PALLAS", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_PALLAS", raising=False)


def _unsorted_case(seed, e, n, f):
    """Unsorted ids over ``n`` segments, the last 10 left empty, a quarter
    of the rows masked (id -1 in ``ids``, False in ``mask``)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, n - 10, e).astype(np.int32)
    mask = rng.random(e) > 0.25
    data = rng.normal(size=(e, f)).astype(np.float32)
    ids = np.where(mask, raw, -1).astype(np.int32)
    return raw, ids, mask, data


def _truth(data, ids, n):
    keep = ids >= 0
    total = np.zeros((n, data.shape[1]))
    np.add.at(total, ids[keep], data[keep].astype(np.float64))
    bound = np.zeros((n, data.shape[1]))
    np.add.at(bound, ids[keep], np.abs(data[keep]).astype(np.float64))
    return total, 2.0**-16 * bound.max(axis=1, keepdims=True)


def _assert_sum(got, want, data, ids, n, hilo):
    truth, bound = _truth(data, ids, n)
    got = np.asarray(got).reshape(n, -1)
    np.testing.assert_allclose(got, truth, rtol=RTOL, atol=ATOL)
    want = np.asarray(want).reshape(n, -1)
    atol = ATOL + (bound if hilo else 0.0)
    assert np.all(np.abs(got - want) <= atol + RTOL * np.abs(want))


@pytest.mark.parametrize("f", [1, 24, 64, 100])
def pytest_sum_count_plain_matches_jax_kernel(f):
    """F <= 64 takes the JAX kernel's packed hi/lo tile, F=100 its
    two-matmul split kernel."""
    n = 90
    _, ids, _, data = _unsorted_case(f, 600, n, f)
    js, jc = jps.segment_sum_count(jnp.asarray(data), jnp.asarray(ids), n, interpret=True)
    ts, tc = ssc.segment_sum_count(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert ts.dtype == torch.float32 and tc.dtype == torch.float32
    assert ts.shape == (n, f) and tc.shape == (n,)
    _assert_sum(ts.numpy(), js, data, ids, n, hilo=True)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert not ts.numpy()[-10:].any() and not tc.numpy()[-10:].any()


def pytest_sum_count_backward_matches_jax():
    n = 70
    _, ids, _, data = _unsorted_case(3, 500, n, 24)
    w = np.random.default_rng(4).normal(size=(n, 24)).astype(np.float32)

    def jloss(d):
        total, count = jps.segment_sum_count(d, jnp.asarray(ids), n, interpret=True)
        return jnp.sum(total * w) + jnp.sum(count)

    want = jax.grad(jloss)(jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_(True)
    total, count = ssc.segment_sum_count(d, torch.from_numpy(ids), n)
    assert not count.requires_grad
    (got,) = torch.autograd.grad((total * torch.from_numpy(w)).sum(), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not got.numpy()[ids < 0].any()


def pytest_sum_count_cpu_never_touches_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")

    monkeypatch.setattr(ssc, "_kernel", refuse)
    before = ssc.KERNEL_LAUNCHES
    _, ids, _, data = _unsorted_case(0, 200, 40, 8)
    ssc.segment_sum_count(torch.from_numpy(data), torch.from_numpy(ids), 40)
    assert ssc.KERNEL_LAUNCHES == before


@pytest.mark.parametrize(
    "bad", ["data_dtype", "data_rank", "noncontig", "ids_dtype", "ids_len", "ids_noncontig"]
)
def pytest_sum_count_rejects_bad_inputs(bad):
    data = torch.zeros(10, 4)
    ids = torch.zeros(10, dtype=torch.int32)
    if bad == "data_dtype":
        data = data.double()
    elif bad == "data_rank":
        data = data.reshape(10, 2, 2)
    elif bad == "noncontig":
        data = torch.zeros(4, 10).t()
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_len":
        ids = ids[:-1]
    else:
        ids = torch.zeros(10, 2, dtype=torch.int32)[:, 0]
    with pytest.raises((TypeError, ValueError)):
        ssc.segment_sum_count(data, ids, 3)


@pytest.mark.parametrize("pallas", [True, False], ids=["jax_one_hot_kernel", "jax_default"])
@pytest.mark.parametrize("op", ["sum_count", "sum", "mean", "stats", "pna"])
def pytest_fused_ops_without_row_ptr_match_jax(monkeypatch, pallas, op):
    """``row_ptr=None``: the JAX side takes its one-hot kernel (with
    ``HYDRAGNN_PALLAS=1``) or its XLA segment ops; the port takes the
    unsorted-id kernel's plain version with masked rows at id -1."""
    _route(monkeypatch, pallas)
    n = 80
    raw, ids, mask, data = _unsorted_case(11, 500, n, 16)
    j = (jnp.asarray(data), jnp.asarray(raw), n)
    t = (torch.from_numpy(data), torch.from_numpy(raw), n)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    if op in ("sum_count", "sum", "mean"):
        name = {"sum_count": "fused_segment_sum_count", "sum": "fused_segment_sum",
                "mean": "fused_segment_mean"}[op]
        want = getattr(jps, name)(*j, mask=jm, sorted_ids=True)
        got = getattr(tcs, name)(*t, mask=tm)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        if op == "mean":
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
        else:
            _assert_sum(got[0].numpy(), want[0], data, ids, n, hilo=pallas)
        if op == "sum_count":
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    elif op == "stats":
        want = jps.fused_segment_stats(*j, mask=jm, sorted_ids=True)
        got = tcs.fused_segment_stats(*t, mask=tm)
        # JAX's fused_segment_stats runs its one-hot kernel on either route.
        _assert_sum(got[0].numpy(), want[0], data, ids, n, hilo=True)
        for name, a, b in zip(("mean", "std", "count"), got[1:], want[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)
    else:
        aggs = ("mean", "min", "max", "std")
        ja, jc = jps.pna_aggregate(*j, aggs, mask=jm, sorted_ids=True)
        ta, tc = tcs.pna_aggregate(*t, aggs, mask=tm)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("pallas", [True, False], ids=["jax_one_hot_kernel", "jax_default"])
def pytest_model_forward_without_pointers_matches_jax(monkeypatch, pallas):
    """``HydraGNN`` on a batch whose ``row_ptr`` and ``graph_ptr`` are None
    matches the JAX model on the same batch, and the port's CSR forward."""
    _route(monkeypatch, pallas)
    cfg = CONFIGS["flagship"]
    graphs = make_graphs(5, 6, cfg)
    host = collate_graphs(graphs, cfg["types"], cfg["dims"], edge_dim=1)
    jb = jcollate.collate_graphs(to_jax_samples(graphs), cfg["types"], cfg["dims"], edge_dim=1)
    jmodel, variables = jax_model_and_variables(cfg, jb)
    j_out = jmodel.apply(variables, jb.replace(row_ptr=None, graph_ptr=None), train=False)
    model = port_model(cfg, variables)
    batch = GraphBatch.from_numpy(host, "cpu")
    bare = GraphBatch.from_numpy(host, "cpu")
    bare.row_ptr = bare.graph_ptr = None
    with torch.inference_mode():
        t_out = model(bare)
        csr_out = model(batch)
    assert_outputs_close(t_out, j_out, cfg["types"], host.node_mask, host.graph_mask)
    assert_outputs_close(t_out, [o.numpy() for o in csr_out], cfg["types"],
                         host.node_mask, host.graph_mask)


def _csr_sorted_case(seed, e, n, f):
    """Sorted raw ids (the CSR contract): the last 3 segments are padding
    and own the masked rows, which are zeroed; segment 0 has one row and
    segment 1 two equal rows (a tie)."""
    rng = np.random.default_rng(seed)
    real = n - 3
    ids = np.sort(np.concatenate([[0, 1, 1], rng.integers(2, real, e - 40 - 3)]))
    ids = np.concatenate([ids, np.full(40, n - 1)]).astype(np.int32)
    data = rng.normal(size=(e, f)).astype(np.float32)
    data[2] = data[1]
    mask = np.arange(e) < e - 40
    data[~mask] = 0.0
    return ids, data, mask, build_row_ptr(ids, n)


def _stats_grad_truth(data, ids, mask, n, w, eps=1e-5):
    """f64 ``d/dx`` of ``Σ sum·w0 + Σ mean·w1 + Σ std·w2`` (the analytic
    form; the std term is 0 on single-row segments), and per row the bound
    on what the JAX kernels' bf16 hi/lo error does to it: the mean is off by
    up to 2^-16·Σ|x| / n, and the std term multiplies that by
    |w2| / (σ·n)."""
    x = data.astype(np.float64)
    total = np.zeros((n, x.shape[1]))
    np.add.at(total, ids[mask], x[mask])
    absum = np.zeros((n, x.shape[1]))
    np.add.at(absum, ids[mask], np.abs(x[mask]))
    cnt = np.bincount(ids[mask], minlength=n).astype(np.float64)[:, None]
    safe = np.maximum(cnt, 1.0)
    mean = total / safe
    sq = np.zeros((n, x.shape[1]))
    np.add.at(sq, ids[mask], (x[mask] - mean[ids[mask]]) ** 2)
    std = np.sqrt(sq / safe + eps)
    quad = np.where(cnt > 1, w[2] / (std * safe), 0.0)
    idx = np.clip(ids, 0, n - 1)
    grad = w[0][idx] + (w[1] / safe)[idx] + quad[idx] * (x - mean[idx])
    hilo = np.abs(quad) * 2.0**-16 * absum.max(axis=1, keepdims=True) / safe
    return np.where(mask[:, None], grad, 0.0), np.where(mask[:, None], hilo[idx], 0.0)


@pytest.mark.parametrize("route", ["csr", "unsorted"])
def pytest_stats_backward_matches_jax(monkeypatch, route):
    """The analytic ``_stats_bwd`` against ``jax.grad`` through the JAX
    kernels (``HYDRAGNN_PALLAS=1``; CSR run walk with ``row_ptr``, one-hot
    without), with a single-row segment and a tie. Held to the f64 truth at
    rtol/atol, and to the JAX value within rtol/atol plus the hi/lo bound of
    :func:`_stats_grad_truth`: the tie makes a segment whose σ is
    ``sqrt(eps)``, where the JAX kernels' mean error is amplified by
    1/(σ·n) ~ 150."""
    _route(monkeypatch, True)
    n, f = 60, 8
    ids, data, mask, row_ptr = _csr_sorted_case(21, 400, n, f)
    rng = np.random.default_rng(22)
    w = [rng.normal(size=(n, f)).astype(np.float32) for _ in range(3)]
    ptr_j = jnp.asarray(row_ptr) if route == "csr" else None
    ptr_t = torch.from_numpy(row_ptr) if route == "csr" else None

    def jloss(d):
        s, m, sd, _ = jps.fused_segment_stats(
            d, jnp.asarray(ids), n, mask=jnp.asarray(mask), sorted_ids=True, row_ptr=ptr_j
        )
        return jnp.sum(s * w[0]) + jnp.sum(m * w[1]) + jnp.sum(sd * w[2])

    want = jax.grad(jloss)(jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_(True)
    s, m, sd, c = tcs.fused_segment_stats(
        d, torch.from_numpy(ids), n, mask=torch.from_numpy(mask), row_ptr=ptr_t
    )
    assert not c.requires_grad
    loss = sum((o * torch.from_numpy(wk)).sum() for o, wk in zip((s, m, sd), w))
    (got,) = torch.autograd.grad(loss, d)
    got = got.numpy()
    truth, hilo = _stats_grad_truth(data, ids, mask, n, w)
    np.testing.assert_allclose(got, truth, rtol=RTOL, atol=ATOL)
    want = np.asarray(want)
    assert np.all(np.abs(got - want) <= ATOL + hilo + RTOL * np.abs(want))
    assert not got[~mask].any()
    # Single-row segment 0: no std term. Tie segment 1: x == mean exactly.
    np.testing.assert_allclose(got[0], w[0][0] + w[1][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], got[2])


def pytest_extrema_backward_matches_jax():
    """Every row equal to its segment's extremum receives the full
    cotangent (``scatter_reduce``'s own backward would split a tie);
    masked rows receive nothing."""
    n, f = 60, 8
    ids, data, mask, _ = _csr_sorted_case(23, 300, n, f)
    ids = np.where(mask, ids, -1).astype(np.int32)
    rng = np.random.default_rng(24)
    w_mn, w_mx = (rng.normal(size=(n, f)).astype(np.float32) for _ in range(2))

    def jloss(d):
        mn, mx = jps.segment_extrema(d, jnp.asarray(ids), n)
        return jnp.sum(mn * w_mn) + jnp.sum(mx * w_mx)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    d = torch.from_numpy(data).requires_grad_(True)
    mn, mx = tcs.segment_extrema(d, torch.from_numpy(ids), n)
    loss = (mn * torch.from_numpy(w_mn)).sum() + (mx * torch.from_numpy(w_mx)).sum()
    (got,) = torch.autograd.grad(loss, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # The tie (rows 1 and 2 of segment 1) gives both rows the full cotangent.
    np.testing.assert_allclose(got.numpy()[1], got.numpy()[2])
    assert np.abs(got.numpy()[1]).min() > 0
