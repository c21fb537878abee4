"""Port parity, the block-skip kernel K4 (``HYDRAGNN_PALLAS_SKIP=1``): the
port's ``segment_sum_count_skip_plain`` and the switched
``segment_sum_count`` against the JAX package's ``segment_sum_count`` with
its ``_skip_kernel`` in interpret mode, on the same numpy inputs, on the
CPU. The switch is set with ``monkeypatch`` for both packages.

Tolerance rtol=1e-4, atol=1e-5. A raw segment SUM from the JAX kernel
carries its bf16 hi/lo error, up to 2^-16 x sum|x| per row (ROADMAP C1): such
sums are held to the f64 truth at rtol/atol and to the JAX value within
atol plus that bound (``_assert_sum``). Counts are exact. The skip plain
version must equal the plain K2/K3 version bit for bit: it adds the same
rows, and a row the block ranges dropped would show."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from hydragnn_tpu.ops import pallas_segment as jps

from hydragnn_tpu_torch.ops import csr_segment as tcs
from hydragnn_tpu_torch.ops import segment_sum_count as ssc

from test_torch_port_sum_count import _assert_sum

RTOL, ATOL = 1e-4, 1e-5


def _switch(monkeypatch, skip=True):
    """The JAX side on its one-hot kernels (interpret mode), both sides with
    the skip switch on or off."""
    monkeypatch.delenv("HYDRAGNN_SEGMENT_SORTED", raising=False)
    monkeypatch.delenv("HYDRAGNN_PALLAS_CSR", raising=False)
    monkeypatch.setenv("HYDRAGNN_PALLAS", "1")
    if skip:
        monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_PALLAS_SKIP", raising=False)


def _reference_case(pattern):
    """The reference test's problem (tests/test_pallas_segment.py): 1400
    edges, 300 segments, 10 columns; more than two edge blocks and two node
    tiles."""
    rng = np.random.default_rng(17)
    e, n, f = 1400, 300, 10
    contiguous = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    scattered = rng.integers(0, n, size=e).astype(np.int32)
    data = (rng.normal(size=(e, f)) * 2.0).astype(np.float32)
    mask = rng.random(e) > 0.2
    ids = {"contiguous": contiguous, "scattered": scattered,
           "masked": np.where(mask, contiguous, -1),
           "scattered_masked": np.where(mask, scattered, -1)}[pattern]
    return data, ids.astype(np.int32), n


def _check_against_jax(data, ids, n):
    js, jc = jps.segment_sum_count(jnp.asarray(data), jnp.asarray(ids), n, interpret=True)
    td, ti = torch.from_numpy(data), torch.from_numpy(ids)
    ts, tc = ssc.segment_sum_count(td, ti, n)
    ps, pc = ssc.segment_sum_count_skip_plain(td, ti, n)
    assert ts.shape == (n, data.shape[1]) and tc.shape == (n,)
    # Both sides drop rows with id >= n, as masked ones.
    _assert_sum(ts.numpy(), js, data, np.where(ids < n, ids, -1), n, hilo=True)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # The ranges and the predicate allow every kept row: equal to the plain
    # K2/K3 version bit for bit.
    want_s, want_c = ssc.segment_sum_count_plain(td, ti, n)
    assert torch.equal(ps, want_s) and torch.equal(pc, want_c)
    assert torch.equal(ts, ps) and torch.equal(tc, pc)


@pytest.mark.parametrize("pattern", ["contiguous", "scattered", "masked", "scattered_masked"])
def pytest_skip_plain_matches_jax_skip_kernel(monkeypatch, pattern):
    _switch(monkeypatch)
    assert ssc.pallas_skip_enabled() and jps.pallas_skip_enabled()
    _check_against_jax(*_reference_case(pattern))


@pytest.mark.parametrize("case", ["masked_block", "straddle", "past_last_segment", "one_row_blocks"])
def pytest_skip_block_edge_cases_match_jax(monkeypatch, case):
    """A wholly masked 512-edge block (lo > hi: no tile overlaps it); runs
    that straddle a 128-row tile and a 512-edge block; ids at or past the
    last segment; blocks whose kept ids all name one row (the padding node
    of messages that pass no mask)."""
    _switch(monkeypatch)
    rng = np.random.default_rng(23)
    n, f = 300, 6
    if case == "masked_block":
        ids = np.sort(rng.integers(0, n, 1600)).astype(np.int32)
        ids[512:1024] = -1
    elif case == "straddle":
        # Row 127 / 128 (a tile edge) across edge 511 / 512 (a block edge).
        ids = np.concatenate([np.full(500, 3), np.full(20, 127), np.full(20, 128),
                              np.sort(rng.integers(129, n, 700))]).astype(np.int32)
    elif case == "past_last_segment":
        ids = np.sort(rng.integers(0, n + 40, 1400)).astype(np.int32)
    else:
        ids = np.concatenate([np.sort(rng.integers(0, n - 1, 700)),
                              np.full(1500, n - 1)]).astype(np.int32)
    data = rng.normal(size=(ids.shape[0], f)).astype(np.float32)
    lo, hi = ssc.block_ranges(torch.from_numpy(ids))
    overlap = ssc.block_overlap(lo, hi, n)
    if case == "masked_block":
        assert int(lo[1]) == 2**31 - 1 and int(hi[1]) == -1
        assert not overlap[:, 1].any()
    elif case == "straddle":
        # Block 1 holds rows 127 and 128: it meets tiles 0 and 1; block 0
        # ends at row 127 and meets tile 0 only.
        assert bool(overlap[0, 1]) and bool(overlap[1, 1]) and bool(overlap[0, 0])
        assert not bool(overlap[1, 0])
    elif case == "one_row_blocks":
        assert int(lo[-1]) == int(hi[-1]) == n - 1
        assert overlap[:, -1].sum() == 1
    _check_against_jax(data, ids, n)


def pytest_skip_ranges_are_the_references():
    """``block_ranges`` equals the reference's inline lo/hi over id >= 0
    (``_sum_count_pallas``), and ``block_overlap`` is ``_block_overlap`` for
    every (node tile, edge block) pair."""
    rng = np.random.default_rng(29)
    n, e = 700, 3000
    ids = np.where(rng.random(e) > 0.3, np.sort(rng.integers(0, n, e)), -1).astype(np.int32)
    ids[1024:1536] = -1
    lo, hi = ssc.block_ranges(torch.from_numpy(ids))
    be = jps._BE
    e_pad = -(-e // be) * be
    blk = jnp.full((e_pad,), -1, jnp.int32).at[:e].set(jnp.asarray(ids)).reshape(-1, be)
    valid = blk >= 0
    want_lo = jnp.where(valid, blk, jnp.int32(2147483647)).min(axis=1)
    want_hi = jnp.where(valid, blk, jnp.int32(-1)).max(axis=1)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(want_lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(want_hi))
    overlap = ssc.block_overlap(lo, hi, n).numpy()
    assert (ssc.BLOCK_EDGES, ssc.TILE_ROWS) == (jps._BE, jps._BN)
    for i in range(overlap.shape[0]):
        for j in range(overlap.shape[1]):
            want = jps._block_overlap(i, j, np.asarray(want_lo), np.asarray(want_hi))
            assert bool(overlap[i, j]) == bool(want), (i, j)


def pytest_skip_gradient_matches_jax(monkeypatch):
    """The gather backward, shared with K2/K3 (the reference's skip variant
    rides the same custom VJP)."""
    _switch(monkeypatch)
    data, ids, n = _reference_case("masked")
    w = np.random.default_rng(4).normal(size=(n, data.shape[1])).astype(np.float32)

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


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def pytest_fused_segment_stats_under_switch_matches_jax(monkeypatch, skip):
    """``fused_segment_stats`` without ``row_ptr`` (both PNA passes) with
    the switch on and off: the same values and the same analytic gradient
    as the JAX package's."""
    _switch(monkeypatch, skip)
    rng = np.random.default_rng(31)
    n, e, f = 200, 1300, 8
    raw = np.sort(rng.integers(0, n - 5, e)).astype(np.int32)
    mask = rng.random(e) > 0.25
    data = rng.normal(size=(e, f)).astype(np.float32)
    ids = np.where(mask, raw, -1).astype(np.int32)
    w = rng.normal(size=(3, n, f)).astype(np.float32)

    def jfn(d):
        total, mean, std, count = jps.fused_segment_stats(
            d, jnp.asarray(raw), n, mask=jnp.asarray(mask), sorted_ids=True)
        return jnp.sum(mean * w[0]) + jnp.sum(std * w[1]), (total, mean, std, count)

    (_, (js, jm, jsd, jc)), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_(True)
    before = ssc.SKIP_LAUNCHES, ssc.KERNEL_LAUNCHES
    ts, tm, tsd, tc = tcs.fused_segment_stats(d, torch.from_numpy(raw), n, mask=torch.from_numpy(mask))
    assert (ssc.SKIP_LAUNCHES, ssc.KERNEL_LAUNCHES) == before  # CPU: plain versions
    (tg,) = torch.autograd.grad(
        (tm * torch.from_numpy(w[0])).sum() + (tsd * torch.from_numpy(w[1])).sum(), d)
    _assert_sum(ts.detach().numpy(), js, data, ids, n, hilo=True)
    for name, a, b in (("mean", tm, jm), ("std", tsd, jsd)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-4)
    assert not tg.numpy()[~mask].any()


def pytest_c3_gradient_at_ids_past_the_last_segment(monkeypatch):
    """ROADMAP C3. Rows with ``id >= num_segments`` are dropped by both
    forwards. The reference's ``_sum_count_bwd`` still gathers
    ``d_sum[clip(id, 0, N - 1)]`` for them (it masks only ``id < 0``), so they
    get the last segment's cotangent, and so does the port's backward: the
    gradients are equal on every row, under the skip switch and without
    it."""
    rng = np.random.default_rng(37)
    n, e, f = 50, 900, 4
    ids = rng.integers(0, n + 10, e).astype(np.int32)
    ids[::11] = -1
    data = rng.normal(size=(e, f)).astype(np.float32)
    w = rng.normal(size=(n, f)).astype(np.float32)
    past = ids >= n
    assert past.any()
    for skip in (True, False):
        _switch(monkeypatch, skip)
        jg = np.asarray(jax.grad(lambda d: jnp.sum(
            jps.segment_sum_count(d, jnp.asarray(ids), n, interpret=True)[0] * w))(jnp.asarray(data)))
        d = torch.from_numpy(data).requires_grad_(True)
        total, _ = ssc.segment_sum_count(d, torch.from_numpy(ids), n)
        (tg,) = torch.autograd.grad((total * torch.from_numpy(w)).sum(), d)
        tg = tg.numpy()
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
        # Both: the last segment's cotangent past it, 0 at masked rows.
        np.testing.assert_allclose(jg[past], np.broadcast_to(w[n - 1], (past.sum(), f)))
        np.testing.assert_array_equal(tg[past], jg[past])
        assert not tg[ids < 0].any()
        # Both forwards drop those rows.
        js, jc = jps.segment_sum_count(jnp.asarray(data), jnp.asarray(ids), n, interpret=True)
        np.testing.assert_array_equal(total.detach().numpy().shape, np.asarray(js).shape)
        np.testing.assert_array_equal(
            ssc.segment_sum_count(torch.from_numpy(data), torch.from_numpy(ids), n)[1].numpy(),
            np.asarray(jc))


@pytest.mark.parametrize("value", [None, "0", "false", "False", "1", "true", "yes"])
def pytest_skip_switch_parses_like_the_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HYDRAGNN_PALLAS_SKIP", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", value)
    assert ssc.pallas_skip_enabled() == jps.pallas_skip_enabled()


def pytest_skip_switch_is_read_at_every_call(monkeypatch):
    """The route follows the switch call by call: a CPU call under it goes
    through the skip plain version, without it through the K2/K3 one."""
    calls = []
    monkeypatch.setattr(ssc, "segment_sum_count_skip_plain",
                        lambda *a: calls.append("k4") or ssc.segment_sum_count_plain(*a))
    data, ids, n = _reference_case("masked")
    args = (torch.from_numpy(data), torch.from_numpy(ids), n)
    monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", "1")
    ssc.segment_sum_count(*args)
    monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", "0")
    ssc.segment_sum_count(*args)
    monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", "1")
    ssc.segment_sum_count_forward(*args)
    assert calls == ["k4", "k4"]


def pytest_skip_cpu_never_touches_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")

    monkeypatch.setattr(ssc, "_skip_kernel", refuse)
    monkeypatch.setattr(ssc, "_kernel", refuse)
    monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", "1")
    before = ssc.SKIP_LAUNCHES
    data, ids, n = _reference_case("scattered_masked")
    ssc.segment_sum_count(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert ssc.SKIP_LAUNCHES == before


@pytest.mark.parametrize("bad", ["data_dtype", "data_rank", "noncontig", "ids_dtype", "ids_len"])
def pytest_skip_rejects_bad_inputs(bad):
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
    else:
        ids = ids[:-1]
    with pytest.raises((TypeError, ValueError)):
        ssc.segment_sum_count_skip_forward(data, ids, 3)
