"""Port parity, the PNA stats bundle on the CSR route: K5's plain version
``csr_segment_stats_plain`` and the port's ``pna_aggregate`` with
``row_ptr`` (one K5 call: sum, mean, std, count, min and max) against the
JAX package's ``fused_segment_stats(..., row_ptr=...)`` plus
``segment_extrema`` and its ``pna_aggregate``, forward and the gradient of
the messages, on the same numpy inputs. Here, on the CPU, the port runs
its plain versions; the JAX side runs its CSR Pallas kernel in interpret
mode (``HYDRAGNN_PALLAS=1``) or its default path, as
``tests/test_torch_port_ops.py`` runs them.

The inputs cover masked rows (padding edges on the last segment, and some
inside real segments), empty segments, single-element segments (whose std
gradient the reference takes as 0), a run of 200 edges and F = 1, 33, 64.
Tolerance rtol 1e-4, atol 1e-5 (f32 sums in another order), for gradients
atol 1e-5 x their largest entry; a raw sum from the JAX hi/lo kernel is
held as in ``test_torch_port_ops.py``; min and max bit-equal."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from hydragnn_tpu.ops import pallas_segment as jps

from hydragnn_tpu_torch.graphs.csr import build_row_ptr
from hydragnn_tpu_torch.ops import csr_segment as tcs

RTOL, ATOL = 1e-4, 1e-5
AGGREGATORS = ("mean", "min", "max", "std")


def _route(monkeypatch, pallas):
    monkeypatch.delenv("HYDRAGNN_SEGMENT_SORTED", raising=False)
    monkeypatch.delenv("HYDRAGNN_PALLAS_CSR", raising=False)
    if pallas:
        monkeypatch.setenv("HYDRAGNN_PALLAS", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_PALLAS", raising=False)


def _case(f, seed=0, n=60, pad_edges=40, inner=True):
    """Sorted ids over ``n`` segments: every fifth real segment empty, every
    fifth (offset 1) a single row, segment 7 a run of 200 rows, the rest
    2-6 rows; the last ``pad_edges`` rows masked on the top (padding)
    segment, and (``inner``) a tenth of the real rows masked too. Masked
    rows hold data, as the messages do."""
    rng = np.random.default_rng(seed + f)
    real = n - 1
    lens = []
    for r in range(real):
        if r % 5 == 0:
            lens.append(0)
        elif r % 5 == 1:
            lens.append(1)
        elif r == 7:
            lens.append(200)
        else:
            lens.append(int(rng.integers(2, 7)))
    ids = np.concatenate([np.repeat(np.arange(real), lens), np.full(pad_edges, n - 1)])
    ids = ids.astype(np.int32)
    e = ids.shape[0]
    data = rng.normal(size=(e, f)).astype(np.float32)
    mask = rng.random(e) > (0.1 if inner else -1.0)
    mask[-pad_edges:] = False
    return data, ids, mask, build_row_ptr(ids, n), n


def _both(data, ids, mask, row_ptr):
    j = dict(data=jnp.asarray(data), ids=jnp.asarray(ids), mask=jnp.asarray(mask),
             row_ptr=jnp.asarray(row_ptr))
    t = dict(data=torch.from_numpy(data), ids=torch.from_numpy(ids),
             mask=torch.from_numpy(mask), row_ptr=torch.from_numpy(row_ptr))
    return j, t


def _hilo_ok(got, want, data, ids, mask, n, rows=None):
    """A raw sum against the JAX hi/lo kernel's: within atol plus its
    2^-16 x sum|x| per row, and within rtol/atol of the f64 truth (at
    ``rows``, default all)."""
    flat = np.where(mask[:, None], np.abs(data).astype(np.float64), 0.0)
    bound = np.zeros((n, data.shape[1]))
    np.add.at(bound, ids, flat)
    truth = np.zeros((n, data.shape[1]))
    np.add.at(truth, ids, np.where(mask[:, None], data, 0).astype(np.float64))
    rows = slice(None) if rows is None else rows
    got, want = got[rows], np.asarray(want)[rows]
    np.testing.assert_allclose(got, truth[rows], rtol=RTOL, atol=ATOL)
    tol = ATOL + 2.0**-16 * bound.max(axis=1, keepdims=True)[rows] + RTOL * np.abs(want)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("pallas", [True, False], ids=["jax_csr_kernel", "jax_default"])
@pytest.mark.parametrize("f", [1, 33, 64])
def pytest_stats_plain_matches_jax(monkeypatch, pallas, f):
    """``csr_segment_stats_plain``: sum, mean, std and count against JAX's
    ``fused_segment_stats`` on the CSR route, min and max bit-equal to
    ``segment_extrema`` over the kept rows. JAX's default route leaves
    masked rows out of the count where the CSR route counts them in their
    segment, so against it only the padding rows are masked and the real
    segments compared."""
    _route(monkeypatch, pallas)
    data, ids, mask, row_ptr, n = _case(f, inner=pallas)
    rows = slice(None) if pallas else slice(0, n - 1)
    j, t = _both(data, ids, mask, row_ptr)
    js, jm, jsd, jc = jps.fused_segment_stats(
        j["data"], j["ids"], n, mask=j["mask"], sorted_ids=True, row_ptr=j["row_ptr"])
    ts, tm, tsd, tc, tmn, tmx = tcs.csr_segment_stats_plain(
        t["data"], t["mask"], t["row_ptr"], n)
    _hilo_ok(ts.numpy(), js, data, ids, mask, n, rows)
    for name, a, b in (("mean", tm, jm), ("std", tsd, jsd)):
        np.testing.assert_allclose(a.numpy()[rows], np.asarray(b)[rows], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(tc.numpy()[rows], np.asarray(jc)[rows])
    jmn, jmx = jps.segment_extrema(j["data"], jnp.where(j["mask"], j["ids"], -1), n)
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))
    # Empty segments: zero sum, mean, min and max, std sqrt(eps).
    empty = np.diff(row_ptr) == 0
    assert empty.sum() >= 10
    for a in (ts, tm, tmn, tmx):
        assert not a.numpy()[empty].any()
    np.testing.assert_allclose(tsd.numpy()[empty], np.sqrt(1e-5), rtol=1e-6)


@pytest.mark.parametrize("f", [1, 33, 64])
def pytest_stats_plain_without_std_or_extrema(f):
    """``want_std=False`` gives std 0 with the same sum, mean and count;
    ``want_extrema=False`` gives no min or max."""
    data, ids, mask, row_ptr, n = _case(f, seed=3)
    _, t = _both(data, ids, mask, row_ptr)
    full = tcs.csr_segment_stats_plain(t["data"], t["mask"], t["row_ptr"], n)
    bare = tcs.csr_segment_stats_plain(t["data"], t["mask"], t["row_ptr"], n,
                                       want_std=False, want_extrema=False)
    assert bare[4] is None and bare[5] is None and not bare[2].any()
    for a, b in zip(full[:2] + full[3:4], bare[:2] + bare[3:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pallas", [True, False], ids=["jax_csr_kernel", "jax_default"])
@pytest.mark.parametrize("f", [1, 33, 64])
@pytest.mark.parametrize(
    "aggregators", [AGGREGATORS, ("sum", "max"), ("mean",), ("min",)],
    ids=["pna", "sum_max", "mean_only", "min_only"],
)
def pytest_pna_aggregate_on_k5_matches_jax(monkeypatch, pallas, f, aggregators):
    """The port's ``pna_aggregate`` with ``row_ptr`` (one K5 call) against
    JAX's, forward and the gradient of the messages (``jax.grad`` through
    ``_stats_bwd`` and ``_extrema_bwd``). Against JAX's default route only
    the padding rows are masked and the real segments compared (its count
    leaves masked rows out)."""
    _route(monkeypatch, pallas)
    data, ids, mask, row_ptr, n = _case(f, seed=5, inner=pallas)
    rows = slice(None) if pallas else slice(0, n - 1)
    j, t = _both(data, ids, mask, row_ptr)
    w = np.random.default_rng(6).normal(size=(n, len(aggregators), f)).astype(np.float32)

    def jax_loss(msg):
        agg, _ = jps.pna_aggregate(msg, j["ids"], n, aggregators, mask=j["mask"],
                                   sorted_ids=True, row_ptr=j["row_ptr"])
        return jnp.sum(agg * w)

    ja, jc = jps.pna_aggregate(j["data"], j["ids"], n, aggregators, mask=j["mask"],
                               sorted_ids=True, row_ptr=j["row_ptr"])
    jg = np.asarray(jax.grad(jax_loss)(j["data"]))
    msg = t["data"].clone().requires_grad_(True)
    before = tcs.STATS_LAUNCHES, tcs.KERNEL_LAUNCHES
    ta, tc = tcs.pna_aggregate(msg, t["ids"], n, aggregators, mask=t["mask"],
                               row_ptr=t["row_ptr"])
    assert (tcs.STATS_LAUNCHES, tcs.KERNEL_LAUNCHES) == before  # CPU: plain versions
    (tg,) = torch.autograd.grad((ta * torch.from_numpy(w)).sum(), msg)
    assert tuple(ta.shape) == tuple(ja.shape)
    for k, a in enumerate(aggregators):
        got = ta[:, k].detach().numpy()
        if a == "sum":
            _hilo_ok(got, ja[:, k], data, ids, mask, n, rows)
        elif a in ("min", "max"):
            np.testing.assert_array_equal(got, np.asarray(ja[:, k]), err_msg=a)
        else:
            np.testing.assert_allclose(got[rows], np.asarray(ja[:, k])[rows], rtol=RTOL,
                                       atol=ATOL, err_msg=a)
    np.testing.assert_array_equal(tc.numpy()[rows], np.asarray(jc)[rows])
    # Gradients at rtol 1e-4 + atol 1e-5 x max|g|, the repo's gradient
    # scale: the std's term (x - μ) / σ of a two-row segment whose rows
    # nearly tie carries the mean's rounding magnified by |x| / |x - μ|.
    # JAX's default route takes the mean from prefix-sum differences, whose
    # noise its own source puts at ~1e-5 absolute and ~5e-3 in the std
    # gradient (pallas_segment.py, _stats_forward); there the port's
    # gradient is held to its own f64 gradient instead.
    scale = ATOL * float(np.abs(jg).max())
    if pallas:
        np.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL, atol=scale)
    else:
        hi = t["data"].double().requires_grad_(True)
        ha, _ = tcs.pna_aggregate(hi, t["ids"], n, aggregators, mask=t["mask"],
                                  row_ptr=t["row_ptr"])
        (hg,) = torch.autograd.grad((ha * torch.from_numpy(w).double()).sum(), hi)
        np.testing.assert_allclose(tg.numpy(), hg.numpy(), rtol=RTOL, atol=scale)
    assert not tg.numpy()[~mask].any()


def pytest_single_element_segments_take_no_std_gradient():
    """The dσ = 0 rule: a segment of one row has x ≡ μ, so the std's
    cotangent reaches none of its rows (the reference's ``_stats_bwd``),
    while the mean's does."""
    data, ids, mask, row_ptr, n = _case(8, seed=7)
    _, t = _both(data, ids, mask, row_ptr)
    msg = t["data"].clone().requires_grad_(True)
    _, _, std, count, _, _ = tcs.csr_segment_stats(msg, t["ids"], n, t["mask"],
                                                   row_ptr=t["row_ptr"])
    (g,) = torch.autograd.grad(std.sum(), msg)
    single = (count == 1).numpy()[ids]
    assert single.sum() >= 10
    assert not g.numpy()[single].any()
    _, mean, _, _, _, _ = tcs.csr_segment_stats(msg, t["ids"], n, t["mask"],
                                                row_ptr=t["row_ptr"])
    (gm,) = torch.autograd.grad(mean.sum(), msg)
    np.testing.assert_array_equal(gm.numpy()[single & mask], 1.0)


def pytest_fused_segment_stats_takes_k5_with_row_ptr(monkeypatch):
    """``fused_segment_stats`` with ``row_ptr`` is one K5 call without
    extrema and no K1 pass, and equals the four stats of ``pna_aggregate``'s
    K5 call; without ``row_ptr`` it stays on the unsorted-id route."""
    data, ids, mask, row_ptr, n = _case(16, seed=9, inner=False)
    _, t = _both(data, ids, mask, row_ptr)
    calls = []
    real = tcs.csr_segment_stats_forward

    def spy(*a, **k):
        calls.append(k.get("want_extrema", a[6] if len(a) > 6 else True))
        return real(*a, **k)

    monkeypatch.setattr(tcs, "csr_segment_stats_forward", spy)
    monkeypatch.setattr(tcs, "csr_segment_sum_count_forward", None)
    got = tcs.fused_segment_stats(t["data"], t["ids"], n, mask=t["mask"], row_ptr=t["row_ptr"])
    assert calls == [False]
    want = tcs.csr_segment_stats(t["data"], t["ids"], n, t["mask"], row_ptr=t["row_ptr"])
    for a, b in zip(got, want[:4]):
        assert torch.equal(a, b)
    bare = tcs.fused_segment_stats(t["data"], t["ids"], n, mask=t["mask"])
    assert len(calls) == 2
    for a, b in zip(got[1:], bare[1:]):
        np.testing.assert_allclose(a.numpy()[:-1], b.numpy()[:-1], rtol=RTOL, atol=ATOL)


def pytest_stats_plain_in_float64():
    """On the CPU the plain version also runs in float64 (an f64 reference
    step), matching the float32 result within f32 rounding."""
    data, ids, mask, row_ptr, n = _case(33, seed=11)
    _, t = _both(data, ids, mask, row_ptr)
    lo = tcs.csr_segment_stats(t["data"], t["ids"], n, t["mask"], row_ptr=t["row_ptr"])
    hi = tcs.csr_segment_stats(t["data"].double(), t["ids"], n, t["mask"], row_ptr=t["row_ptr"])
    assert all(a.dtype == torch.float64 for a in hi[:3] + hi[4:])
    for a, b in zip(lo, hi):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_len", "ptr_dtype", "data_rank", "ids_len"])
def pytest_stats_rejects_bad_inputs(bad):
    data, ids, mask, row_ptr, n = _case(4, seed=13)
    _, t = _both(data, ids, mask, row_ptr)
    if bad == "mask_dtype":
        t["mask"] = t["mask"].float()
    elif bad == "mask_len":
        t["mask"] = t["mask"][:-1]
    elif bad == "ptr_dtype":
        t["row_ptr"] = t["row_ptr"].long()
    elif bad == "data_rank":
        t["data"] = t["data"][:, :, None]
    else:
        t["ids"] = t["ids"][:-1]
    with pytest.raises((TypeError, ValueError)):
        tcs.csr_segment_stats(t["data"], t["ids"], n, t["mask"], row_ptr=t["row_ptr"])


def pytest_stats_cpu_never_touches_the_kernel(monkeypatch):
    """On CPU tensors K5's wrapper runs the plain version: no build, no
    launch counted."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")

    monkeypatch.setattr(tcs, "_stats_kernel", refuse)
    before = tcs.STATS_LAUNCHES
    data, ids, mask, row_ptr, n = _case(8, seed=15)
    _, t = _both(data, ids, mask, row_ptr)
    tcs.pna_aggregate(t["data"], t["ids"], n, AGGREGATORS, mask=t["mask"], row_ptr=t["row_ptr"])
    assert tcs.STATS_LAUNCHES == before
