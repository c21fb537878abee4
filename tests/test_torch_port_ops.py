"""Port parity, ops: the PyTorch port's segment ops and its CSR segment-sum
path (``hydragnn_tpu_torch.ops``) against the JAX package's on the same numpy
inputs. Here, on the CPU, the port's wrappers run their plain PyTorch
versions; the JAX side runs its Pallas CSR kernel in interpret mode, as its
own tests do.

Tolerances: K1's sums are held to ``KERNEL_CERT_GATE.fwd`` (5e-4 absolute
on unit-scale data) because the JAX kernel sums bf16 hi/lo halves, which is
not exact f32; counts are exact. The fused wrappers are compared at real
rows at rtol=1e-4, atol=1e-5 (f32 sums in another order; on the JAX default
path the std is the uncentered formula). One exception, recorded in
ROADMAP.md §C: a raw segment SUM that the JAX side took from a bf16 hi/lo
Pallas kernel carries that kernel's own error, up to 2^-16 * sum|x| per row
(hi and lo each round to 8 significant bits), which exceeds atol=1e-5 on
rows of ~10 unit-scale values. Such sums are held to the JAX value within
atol=1e-5 plus that bound, and to the f64 truth at rtol=1e-4, atol=1e-5."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import torch

from hydragnn_tpu.ops import pallas_segment as jps
from hydragnn_tpu.ops import segment as jseg
from hydragnn_tpu.precision.tolerance import KERNEL_CERT_GATE

from hydragnn_tpu_torch.graphs.csr import build_row_ptr
from hydragnn_tpu_torch.ops import csr_segment as tcs
from hydragnn_tpu_torch.ops import segment as tseg

RTOL, ATOL = 1e-4, 1e-5


def _hilo_bound(data, ids, n, mask):
    """[n, 1] bound on a bf16 hi/lo kernel's per-row sum error: 2^-16 times
    the row's sum of |x| over unmasked rows."""
    flat = np.abs(data.reshape(data.shape[0], -1)).astype(np.float64)
    flat[~mask] = 0.0
    bound = np.zeros((n, flat.shape[1]))
    np.add.at(bound, ids, flat)
    return 2.0**-16 * bound.max(axis=1, keepdims=True)


def _truth_sum(data, ids, n, mask):
    out = np.zeros((n,) + data.shape[1:])
    np.add.at(out, ids[mask], data[mask].astype(np.float64))
    return out


def _assert_sum_matches(got, want, data, ids, mask, n, real, hilo):
    """A segment sum: to the f64 truth at RTOL/ATOL and to the JAX value at
    RTOL/ATOL, widened by the hi/lo bound when the JAX side used it."""
    got = got.numpy()[:real]
    np.testing.assert_allclose(
        got, _truth_sum(data, ids, n, mask)[:real], rtol=RTOL, atol=ATOL
    )
    atol = ATOL
    if hilo:
        bound = _hilo_bound(data, ids, n, mask)[:real]
        atol = ATOL + bound.reshape(bound.shape + (1,) * (got.ndim - 2))
    want = np.asarray(want)[:real]
    assert np.all(np.abs(got - want) <= atol + RTOL * np.abs(want))


def _csr_case(seed, e, n, f, n_pad_rows=3, n_pad_edges=40):
    """Sorted ids over ``n`` segments with empty rows, the last
    ``n_pad_rows`` rows padding: the final ``n_pad_edges`` edges (masked,
    zeroed) land on the top row, as collation lays them out."""
    rng = np.random.default_rng(seed)
    real = n - n_pad_rows
    # Every third real row stays empty.
    owners = np.asarray([r for r in range(real) if r % 3 != 2])
    ids = np.sort(rng.choice(owners, e - n_pad_edges)).astype(np.int32)
    ids = np.concatenate([ids, np.full(n_pad_edges, n - 1, np.int32)])
    data = rng.normal(size=(e, f)).astype(np.float32)
    mask = np.ones(e, bool)
    mask[-n_pad_edges:] = False
    data[~mask] = 0.0
    return ids, data, mask, build_row_ptr(ids, n), real


@pytest.mark.parametrize("f", [8, 64, 96])
def pytest_csr_sum_count_plain_matches_jax_kernel(f):
    """F=8 and F=64 take the JAX kernel's packed hi/lo tile (2F <= 128);
    F=96 its two-matmul split path."""
    e, n = 700, 150
    ids, data, _, row_ptr, _ = _csr_case(f, e, n, f)
    js, jc = jps.csr_segment_sum_count(
        jnp.asarray(data), jnp.asarray(row_ptr), jnp.asarray(ids), n,
        interpret=True,
    )
    ts, tc = tcs.csr_segment_sum_count(
        torch.from_numpy(data), torch.from_numpy(row_ptr), torch.from_numpy(ids), n
    )
    assert ts.dtype == torch.float32 and tc.dtype == torch.float32
    assert ts.shape == (n, f) and tc.shape == (n,)
    np.testing.assert_allclose(
        ts.numpy(), np.asarray(js), rtol=0, atol=KERNEL_CERT_GATE.fwd
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # Empty rows are exact zeros; the f64 truth bounds the plain version too.
    empty = np.diff(row_ptr) == 0
    assert empty.sum() > 10
    assert not ts.numpy()[empty].any()
    truth = np.zeros((n, f))
    np.add.at(truth, ids, data.astype(np.float64))
    np.testing.assert_allclose(ts.numpy(), truth, rtol=0, atol=1e-5)


def pytest_csr_sum_count_walks_only_the_runs():
    """Rows past the last run and rows outside [row_ptr[0], row_ptr[-1])
    contribute nothing; zero segments give empty outputs."""
    data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    row_ptr = torch.tensor([1, 3, 3, 5], dtype=torch.int32)
    ids = torch.tensor([0, 0, 0, 2, 2, 2], dtype=torch.int32)
    s, c = tcs.csr_segment_sum_count(data, row_ptr, ids, 3)
    np.testing.assert_array_equal(s.numpy(), [[2 + 4, 3 + 5], [0, 0], [6 + 8, 7 + 9]])
    np.testing.assert_array_equal(c.numpy(), [2, 0, 2])
    s0, c0 = tcs.csr_segment_sum_count(data, torch.zeros(1, dtype=torch.int32), ids, 0)
    assert s0.shape == (0, 2) and c0.shape == (0,)


@pytest.mark.parametrize(
    "bad",
    ["data_dtype", "data_rank", "noncontig", "ptr_dtype", "ptr_len", "ptr_noncontig",
     "ids_dtype", "ids_len"],
)
def pytest_csr_sum_count_rejects_bad_inputs(bad):
    data = torch.zeros(10, 4)
    row_ptr = torch.tensor([0, 4, 10], dtype=torch.int32)
    ids = torch.tensor([0] * 4 + [1] * 6, dtype=torch.int32)
    n = 2
    if bad == "data_dtype":
        data = data.double()
    elif bad == "data_rank":
        data = data.reshape(10, 2, 2)
    elif bad == "noncontig":
        data = torch.zeros(4, 10).t()
    elif bad == "ptr_dtype":
        row_ptr = row_ptr.long()
    elif bad == "ptr_len":
        n = 3
    elif bad == "ptr_noncontig":
        row_ptr = torch.tensor([[0, 9], [4, 9], [10, 9]], dtype=torch.int32)[:, 0]
    elif bad == "ids_dtype":
        ids = ids.float()
    elif bad == "ids_len":
        ids = ids[:-1]
    with pytest.raises((TypeError, ValueError)):
        tcs.csr_segment_sum_count(data, row_ptr, ids, n)


def pytest_csr_sum_count_cpu_never_touches_the_kernel(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no build, no
    launch counted."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")

    monkeypatch.setattr(tcs, "_kernel", refuse)
    before = tcs.KERNEL_LAUNCHES
    ids, data, _, row_ptr, _ = _csr_case(0, 200, 40, 8)
    tcs.csr_segment_sum_count(
        torch.from_numpy(data), torch.from_numpy(row_ptr), torch.from_numpy(ids), 40
    )
    assert tcs.KERNEL_LAUNCHES == before


def _route(monkeypatch, pallas):
    """``pallas`` on: the JAX wrappers take the CSR Pallas kernel (read at
    trace time); off: their default CPU path."""
    monkeypatch.delenv("HYDRAGNN_SEGMENT_SORTED", raising=False)
    monkeypatch.delenv("HYDRAGNN_PALLAS_CSR", raising=False)
    if pallas:
        monkeypatch.setenv("HYDRAGNN_PALLAS", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_PALLAS", raising=False)


def _np(t):
    return t["data"].numpy(), t["ids"].numpy(), t["mask"].numpy()


def _inputs(seed, e=600, n=120, f=16):
    ids, data, mask, row_ptr, real = _csr_case(seed, e, n, f)
    j = dict(data=jnp.asarray(data), ids=jnp.asarray(ids), mask=jnp.asarray(mask),
             row_ptr=jnp.asarray(row_ptr))
    t = dict(data=torch.from_numpy(data), ids=torch.from_numpy(ids),
             mask=torch.from_numpy(mask), row_ptr=torch.from_numpy(row_ptr))
    return j, t, n, real


@pytest.mark.parametrize("pallas", [True, False], ids=["jax_csr_kernel", "jax_default"])
def pytest_fused_segment_stats_matches_jax(monkeypatch, pallas):
    _route(monkeypatch, pallas)
    j, t, n, real = _inputs(11)
    jt = jps.fused_segment_stats(
        j["data"], j["ids"], n, mask=j["mask"], sorted_ids=True, row_ptr=j["row_ptr"]
    )
    tt = tcs.fused_segment_stats(
        t["data"], t["ids"], n, mask=t["mask"], row_ptr=t["row_ptr"]
    )
    # JAX's fused_segment_stats runs a bf16 hi/lo Pallas kernel (CSR or
    # one-hot) on either route.
    _assert_sum_matches(tt[0], jt[0], *_np(t), n, real, hilo=True)
    for name, a, b in zip(("mean", "std", "count"), jt[1:], tt[1:]):
        np.testing.assert_allclose(
            b.numpy()[:real], np.asarray(a)[:real], rtol=RTOL, atol=ATOL, err_msg=name
        )
    _, _, std0, _ = tcs.fused_segment_stats(
        t["data"], t["ids"], n, mask=t["mask"], want_std=False, row_ptr=t["row_ptr"]
    )
    assert not std0.any()


@pytest.mark.parametrize("pallas", [True, False], ids=["jax_csr_kernel", "jax_default"])
@pytest.mark.parametrize("shape", [(16,), (3, 5), ()], ids=["2d", "3d", "1d"])
def pytest_fused_segment_mean_and_sum_match_jax(monkeypatch, pallas, shape):
    _route(monkeypatch, pallas)
    rng = np.random.default_rng(12)
    ids, _, mask, row_ptr, real = _csr_case(12, 500, 90, 1)
    data = rng.normal(size=(500,) + shape).astype(np.float32)
    args_j = (jnp.asarray(data), jnp.asarray(ids), 90)
    args_t = (torch.from_numpy(data), torch.from_numpy(ids), 90)
    kw_j = dict(mask=jnp.asarray(mask), sorted_ids=True, row_ptr=jnp.asarray(row_ptr))
    kw_t = dict(mask=torch.from_numpy(mask), row_ptr=torch.from_numpy(row_ptr))
    want = jps.fused_segment_mean(*args_j, **kw_j)
    got = tcs.fused_segment_mean(*args_t, **kw_t)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(
        got.numpy()[:real], np.asarray(want)[:real], rtol=RTOL, atol=ATOL
    )
    want = jps.fused_segment_sum(*args_j, **kw_j)
    got = tcs.fused_segment_sum(*args_t, **kw_t)
    assert tuple(got.shape) == tuple(want.shape)
    _assert_sum_matches(got, want, data, ids, mask, 90, real, hilo=pallas)
    _, count = tcs.fused_segment_sum_count(
        *args_t, mask=torch.from_numpy(mask), row_ptr=torch.from_numpy(row_ptr)
    )
    np.testing.assert_array_equal(count.numpy(), np.diff(row_ptr))


@pytest.mark.parametrize("pallas", [True, False], ids=["jax_csr_kernel", "jax_default"])
@pytest.mark.parametrize(
    "aggregators",
    [("mean", "min", "max", "std"), ("sum", "max"), ("min",)],
    ids=["pna", "sum_max", "min_only"],
)
def pytest_pna_aggregate_matches_jax(monkeypatch, pallas, aggregators):
    _route(monkeypatch, pallas)
    j, t, n, real = _inputs(13)
    ja, jc = jps.pna_aggregate(
        j["data"], j["ids"], n, aggregators, mask=j["mask"], sorted_ids=True,
        row_ptr=j["row_ptr"],
    )
    ta, tc = tcs.pna_aggregate(
        t["data"], t["ids"], n, aggregators, mask=t["mask"], row_ptr=t["row_ptr"]
    )
    assert tuple(ta.shape) == tuple(ja.shape)
    for k, a in enumerate(aggregators):
        if a == "sum":
            _assert_sum_matches(ta[:, k], ja[:, k], *_np(t), n, real, hilo=pallas)
        else:
            np.testing.assert_allclose(
                ta[:, k].numpy()[:real], np.asarray(ja[:, k])[:real],
                rtol=RTOL, atol=ATOL, err_msg=a,
            )
    np.testing.assert_array_equal(tc.numpy()[:real], np.asarray(jc)[:real])
    with pytest.raises(ValueError, match="Unknown aggregator"):
        tcs.pna_aggregate(t["data"], t["ids"], n, ("median",), row_ptr=t["row_ptr"])


@pytest.mark.parametrize(
    "op", ["fused_segment_sum_count", "fused_segment_sum", "fused_segment_mean",
           "fused_segment_stats"],
)
def pytest_fused_ops_require_row_ptr(monkeypatch, op):
    """``row_ptr`` picks the kernel: with it every (sum, count) is the CSR
    kernel K1 and the stats one launch of the CSR stats kernel K5, without
    it every pass is the unsorted-id kernel (``segment_sum_count``) with
    masked rows at id -1; neither route falls back to the plain segment
    ops."""
    _, t, n, real = _inputs(17)
    calls = {"csr": 0, "k5": 0, "ssc": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tcs, "csr_segment_sum_count_forward",
                        spy("csr", tcs.csr_segment_sum_count_forward))
    monkeypatch.setattr(tcs, "csr_segment_stats_forward",
                        spy("k5", tcs.csr_segment_stats_forward))
    monkeypatch.setattr(tcs.ssc, "segment_sum_count_forward",
                        spy("ssc", tcs.ssc.segment_sum_count_forward))
    monkeypatch.setattr(tcs.seg, "segment_sum", None)
    with_ptr = getattr(tcs, op)(t["data"], t["ids"], n, mask=t["mask"], row_ptr=t["row_ptr"])
    stats = op == "fused_segment_stats"
    passes = 2 if stats else 1
    assert calls == {"csr": 0 if stats else 1, "k5": 1 if stats else 0, "ssc": 0}
    without = getattr(tcs, op)(t["data"], t["ids"], n, mask=t["mask"])
    assert calls == {"csr": 0 if stats else 1, "k5": 1 if stats else 0, "ssc": passes}
    for a, b in zip(with_ptr if isinstance(with_ptr, tuple) else (with_ptr,),
                    without if isinstance(without, tuple) else (without,)):
        np.testing.assert_allclose(a.numpy()[:real], b.numpy()[:real], rtol=RTOL, atol=ATOL)
    tcs.pna_aggregate(t["data"], t["ids"], n, ("mean",), mask=t["mask"])
    assert calls["ssc"] == passes + 1


def pytest_segment_extrema_matches_jax():
    ids, data, mask, _, _ = _csr_case(14, 300, 60, 8)
    ids = np.where(mask, ids, -1).astype(np.int32)
    jmn, jmx = jps.segment_extrema(jnp.asarray(data), jnp.asarray(ids), 60)
    tmn, tmx = tcs.segment_extrema(torch.from_numpy(data), torch.from_numpy(ids), 60)
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("op", ["sum", "count", "mean", "max", "min", "std"])
def pytest_plain_segment_ops_match_jax(op, masked):
    rng = np.random.default_rng(15)
    e, n = 400, 50
    ids = rng.integers(0, n - 5, e).astype(np.int32)  # unsorted; 5 empty rows
    data = rng.normal(size=(e, 6)).astype(np.float32)
    mask = rng.random(e) > 0.3
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    if op == "count":
        want = jseg.segment_count(jnp.asarray(ids), n, mask=jm)
        got = tseg.segment_count(torch.from_numpy(ids), n, mask=tm)
    else:
        kw = {"fill": -3.0} if op in ("max", "min") else {}
        want = getattr(jseg, f"segment_{op}")(jnp.asarray(data), jnp.asarray(ids), n, mask=jm, **kw)
        got = getattr(tseg, f"segment_{op}")(torch.from_numpy(data), torch.from_numpy(ids), n, mask=tm, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis", [0, None])
def pytest_masked_mean_matches_jax(axis):
    rng = np.random.default_rng(16)
    data = rng.normal(size=(30, 4)).astype(np.float32)
    mask = rng.random(30) > 0.5
    want = jseg.masked_mean(jnp.asarray(data), jnp.asarray(mask), axis=axis)
    got = tseg.masked_mean(torch.from_numpy(data), torch.from_numpy(mask), axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
