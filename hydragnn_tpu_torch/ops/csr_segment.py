"""Segment reductions on the port's kernels: CSR (sum, count), and the fused
ops over it and over the unsorted-id kernel.

:func:`csr_segment_sum_count` is the port of the reference's CSR run-walk
Pallas kernel (``hydragnn_tpu/ops/pallas_segment.py``: ``_csr_kernel``,
launched by ``_csr_sum_count_pallas``; entry ``csr_segment_sum_count``).
Given destination-sorted data rows and ``row_ptr [N + 1]`` it returns per
row ``sum [N, F]`` over the run ``[row_ptr[n], row_ptr[n + 1])`` and
``count [N] = row_ptr[n + 1] - row_ptr[n]``. On a CUDA tensor it launches
``csrc/csr_segment.cu`` (built by ``ops/_build.py``) or raises; on a CPU
tensor it runs :func:`csr_segment_sum_count_plain`. There is no other route.
Its backward is the reference's ``_csr_sum_count_bwd``, a gather through the
raw ids: ``d_data[e] = d_sum[clip(ids[e], 0, N - 1)]``.

The fused ops take the reference's routes (``_sorted_route``):

* with ``row_ptr`` (the CSR contract: sorted raw ids, masked rows zeroed and
  owned by padding segments) every (sum, count) pass is
  :func:`csr_segment_sum_count`;
* without it (``row_ptr=None``) masked rows get id -1 and every pass is
  ``ops/segment_sum_count.py``'s unsorted-id kernel, which leaves them out.

The ops are :func:`fused_segment_sum_count`, :func:`fused_segment_sum`,
:func:`fused_segment_mean` (the readout mean pool), :func:`fused_segment_stats`
(pass 1 gives (sum, count) and the mean, pass 2 sums the squared centred
values, ``std = sqrt(sumsq / max(count, 1) + eps)``, with the reference's
analytic backward ``_stats_bwd``) and :func:`pna_aggregate`, which adds
min/max from :func:`segment_extrema` (plain ``scatter_reduce``, with the
reference's ``_extrema_bwd``: every row equal to its segment's extremum
receives the full cotangent).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from . import segment as seg
from . import segment_sum_count as ssc

# Launches of the CUDA kernel, counted by the wrapper at each launch and
# nowhere else. A run resets it to 0 and reads it after to show that a path
# went through the kernel.
KERNEL_LAUNCHES = 0


def _check(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int, ids=None
) -> None:
    if data.dim() != 2:
        raise ValueError(f"data must be [E, F], got shape {tuple(data.shape)}")
    if data.dtype != torch.float32:
        raise TypeError(f"data must be float32, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if row_ptr.dtype != torch.int32:
        raise TypeError(f"row_ptr must be int32, got {row_ptr.dtype}")
    if tuple(row_ptr.shape) != (num_segments + 1,):
        raise ValueError(
            f"row_ptr must have num_segments + 1 = {num_segments + 1} "
            f"entries, got shape {tuple(row_ptr.shape)}"
        )
    if not row_ptr.is_contiguous():
        raise ValueError("row_ptr must be contiguous")
    if data.device != row_ptr.device:
        raise ValueError(
            f"data on {data.device} but row_ptr on {row_ptr.device}"
        )
    if ids is not None:
        if ids.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
        if tuple(ids.shape) != (data.shape[0],):
            raise ValueError(
                f"ids must have one entry per data row ({data.shape[0]}), "
                f"got shape {tuple(ids.shape)}"
            )
        if ids.device != data.device:
            raise ValueError(f"data on {data.device} but ids on {ids.device}")
    if max(data.shape[0], data.shape[1], num_segments) >= 2**31:
        raise ValueError("sizes must fit a 32-bit int")


def csr_segment_sum_count_plain(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ids from the pointer
    differences, then ``index_add_`` over the rows the runs cover."""
    counts = row_ptr.diff()
    ids = torch.repeat_interleave(
        torch.arange(num_segments, device=data.device), counts.long()
    )
    start = int(row_ptr[0])
    total = torch.zeros(
        (num_segments, data.shape[1]), dtype=torch.float32, device=data.device
    )
    total.index_add_(0, ids, data[start : start + ids.shape[0]])
    return total, counts.to(torch.float32)


@functools.cache
def _kernel():
    """``(entry point, edges per chunk)`` of the built library."""
    lib = _build.load("csr_segment")
    fn = lib.csr_segment_sum_count_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.csr_segment_chunk_edges.restype = ctypes.c_int
    return fn, int(lib.csr_segment_chunk_edges())


def csr_segment_sum_count_forward(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(sum [N, F] f32, count [N] f32)`` over the runs of
    ``row_ptr [N + 1]`` int32, ``N = num_segments``, for ``data [E, F]``
    float32 contiguous, without a gradient. ``row_ptr`` must satisfy the
    CSR contract (``graphs/csr.py``): non-decreasing, within ``[0, E]``.
    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    global KERNEL_LAUNCHES
    _check(data, row_ptr, num_segments)
    if data.device.type == "cpu":
        return csr_segment_sum_count_plain(data, row_ptr, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    e, f = data.shape
    total = torch.empty((num_segments, f), dtype=torch.float32, device=data.device)
    count = torch.empty((num_segments,), dtype=torch.float32, device=data.device)
    if num_segments == 0:
        return total, count
    fn, chunk = _kernel()
    # Head and tail partials of the runs longer than one chunk.
    scratch = torch.empty(
        (2, -(-e // chunk), f), dtype=torch.float32, device=data.device
    )
    vec4 = f % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (data, total, scratch)
    )
    with torch.cuda.device(data.device):
        err = fn(
            data.data_ptr(), row_ptr.data_ptr(), total.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), num_segments, e, f, int(vec4),
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"csr_segment_sum_count launch failed with CUDA error {err} "
            f"(num_segments={num_segments}, E={e}, F={f})"
        )
    KERNEL_LAUNCHES += 1
    return total, count


def _clipped(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ``clip(ids, 0, N - 1)`` for the backward's gathers."""
    return ids.long().clamp(0, max(num_segments - 1, 0))


class _CsrSumCount(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_ptr, ids, num_segments):
        total, count = csr_segment_sum_count_forward(data, row_ptr, num_segments)
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return total, count

    @staticmethod
    def backward(ctx, d_sum, d_count):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (ids,) = ctx.saved_tensors
        if ctx.num_segments == 0:
            return d_sum.new_zeros((ids.shape[0], d_sum.shape[1])), None, None, None
        return d_sum.index_select(0, _clipped(ids, ctx.num_segments)), None, None, None


def csr_segment_sum_count(
    data: torch.Tensor, row_ptr: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`csr_segment_sum_count_forward` with the reference's gather
    backward (``_csr_sum_count_bwd``). ``ids [E]`` are the raw segment ids
    of the rows (the forward walks ``row_ptr`` alone; the backward gathers
    ``d_sum`` through them), as in the reference's signature."""
    _check(data, row_ptr, num_segments, ids)
    return _CsrSumCount.apply(data, row_ptr, ids, num_segments)


def _flatten_trailing(data: torch.Tensor):
    """[E, ...] → ([E, F], unflatten) for the 2-D kernel."""
    if data.dim() == 2:
        return data, lambda x: x
    shape = tuple(data.shape)
    if data.dim() == 1:
        return data[:, None], lambda x: x[:, 0]
    return data.reshape(shape[0], -1), lambda x: x.reshape((x.shape[0],) + shape[1:])


def _zero_masked(data: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return data
    return torch.where(mask[:, None], data, torch.zeros((), dtype=data.dtype, device=data.device))


def _masked_ids(ids: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """int32 ids with -1 at masked rows (the unsorted-id route)."""
    ids = ids.to(torch.int32)
    if mask is not None:
        ids = torch.where(mask, ids, torch.full_like(ids, -1))
    return ids.contiguous()


def fused_segment_sum_count(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    row_ptr: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked ``(segment_sum, segment_count)`` in one kernel call. With
    ``row_ptr`` (the CSR contract) the count includes masked rows of padding
    segments; without it masked rows are left out of both outputs."""
    flat, unflatten = _flatten_trailing(data)
    flat = flat.to(torch.float32)
    if row_ptr is not None:
        total, count = csr_segment_sum_count(
            _zero_masked(flat, mask).contiguous(), row_ptr, segment_ids, num_segments
        )
    else:
        total, count = ssc.segment_sum_count(
            flat.contiguous(), _masked_ids(segment_ids, mask), num_segments
        )
    return unflatten(total.to(data.dtype)), count


def fused_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    total, _ = fused_segment_sum_count(
        data, segment_ids, num_segments, mask=mask, row_ptr=row_ptr
    )
    return total


def fused_segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked ``segment_mean`` (the global mean-pool readout), in
    ``data.dtype``."""
    total, count = fused_segment_sum_count(
        data, segment_ids, num_segments, mask=mask, row_ptr=row_ptr
    )
    safe = seg._expand(count.clamp_min(1.0), total)
    return (total / safe).to(data.dtype)


def _sum_count_pass(data, ids, row_ptr, num_segments):
    """One (sum, count) kernel pass of the stats, without a gradient."""
    if row_ptr is not None:
        return csr_segment_sum_count_forward(data, row_ptr, num_segments)
    return ssc.segment_sum_count_forward(data, ids, num_segments)


class _Stats(torch.autograd.Function):
    """The reference's ``_stats`` with its analytic, scatter-free backward
    ``_stats_bwd``: with ``s = Σx``, ``μ = s / n`` and ``σ = sqrt(Σ(x − μ)² / n
    + eps)``, ``Σ_e (x_e − μ) = 0`` removes the μ-coupling inside σ, so
    ``dx_e = ds + dμ / n + dσ·(x_e − μ) / (σ·n)`` at the row's segment, with
    dσ taken as 0 where ``count <= 1`` (there ``x ≡ μ``; this keeps the
    ``1 / sqrt(eps)`` factor off rounding residue) and 0 on rows whose id is
    negative. Autograd through the two passes would keep both terms."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, eps, want_std, row_ptr):
        total, count = _sum_count_pass(data, ids, row_ptr, num_segments)
        safe = count.clamp_min(1.0)[:, None]
        mean = total / safe
        if want_std:
            idx = _clipped(ids, num_segments)
            zero = torch.zeros((), dtype=data.dtype, device=data.device)
            centered = torch.where(
                (ids >= 0)[:, None], data - mean.index_select(0, idx), zero
            )
            sumsq, _ = _sum_count_pass(
                centered.square().contiguous(), ids, row_ptr, num_segments
            )
            std = torch.sqrt(sumsq / safe + eps)
        else:
            std = torch.zeros_like(mean)
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(data, ids, mean, std, count)
        ctx.num_segments = num_segments
        ctx.want_std = want_std
        return total, mean, std, count

    @staticmethod
    def backward(ctx, d_total, d_mean, d_std, d_count):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        data, ids, mean, std, count = ctx.saved_tensors
        idx = _clipped(ids, ctx.num_segments)
        safe = count.clamp_min(1.0)[:, None]
        d_data = (d_total + d_mean / safe).index_select(0, idx)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        if ctx.want_std:
            per_seg_quad = torch.where(count[:, None] > 1.0, d_std / (std * safe), zero)
            d_data = d_data + per_seg_quad.index_select(0, idx) * (
                data - mean.index_select(0, idx)
            )
        d_data = torch.where((ids >= 0)[:, None], d_data, zero)
        return d_data, None, None, None, None, None


def fused_segment_stats(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    want_std: bool = True,
    *,
    row_ptr: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sum, mean, std, count)`` per segment of ``data [E, F]`` from two
    kernel passes: (sum, count) gives ``mean = sum / max(count, 1)``; the
    second sums ``square(where(ids >= 0, x - mean[ids], 0))`` and ``std =
    sqrt(sumsq / max(count, 1) + eps)``. The centred form has no
    cancellation. ``want_std=False`` skips pass 2 (std comes back zero).
    With ``row_ptr`` masked rows are zeroed and ids stay raw (the CSR
    contract); without it masked rows get id -1."""
    data = data.to(torch.float32)
    if row_ptr is not None:
        data, ids = _zero_masked(data, mask), segment_ids
    else:
        ids = _masked_ids(segment_ids, mask)
    return _Stats.apply(data.contiguous(), ids, num_segments, eps, want_std, row_ptr)


class _Extrema(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        mask = ids >= 0
        safe_ids = torch.where(mask, ids, torch.zeros_like(ids))
        mn = seg.segment_min(data, safe_ids, num_segments, mask=mask)
        mx = seg.segment_max(data, safe_ids, num_segments, mask=mask)
        ctx.save_for_backward(data, ids, mn, mx)
        ctx.num_segments = num_segments
        return mn, mx

    @staticmethod
    def backward(ctx, d_mn, d_mx):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        data, ids, mn, mx = ctx.saved_tensors
        idx = _clipped(ids, ctx.num_segments)
        valid = (ids >= 0)[:, None]
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        d_data = torch.where(
            valid & (data == mn.index_select(0, idx)), d_mn.index_select(0, idx), zero
        ) + torch.where(
            valid & (data == mx.index_select(0, idx)), d_mx.index_select(0, idx), zero
        )
        return d_data, None, None


def segment_extrema(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min, max)`` per segment; ``ids < 0`` marks masked rows and empty
    segments yield 0. Plain ``scatter_reduce`` (``ops/segment.py``) with the
    reference's subgradient backward (``_extrema_bwd``)."""
    return _Extrema.apply(data, ids, num_segments)


def pna_aggregate(
    msg: torch.Tensor,
    receivers: torch.Tensor,
    num_segments: int,
    aggregators: Sequence[str],
    mask: Optional[torch.Tensor] = None,
    *,
    row_ptr: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PNA multi-aggregator bundle → ``(stacked [N, A, F], count [N])``:
    sum/mean/std from :func:`fused_segment_stats` (two kernel calls),
    min/max from :func:`segment_extrema`."""
    fused = {}
    count = None
    if any(a in ("mean", "std", "sum") for a in aggregators):
        total, mean, std, count = fused_segment_stats(
            msg, receivers, num_segments, mask=mask,
            want_std="std" in aggregators, row_ptr=row_ptr,
        )
        fused.update(mean=mean, std=std, sum=total)
    if "min" in aggregators or "max" in aggregators:
        ids = receivers.long()
        if mask is not None:
            ids = torch.where(mask, ids, torch.full_like(ids, -1))
        fused["min"], fused["max"] = segment_extrema(msg, ids, num_segments)
    for a in aggregators:
        if a not in fused:
            raise ValueError(f"Unknown aggregator {a}")
    if count is None:
        count = seg.segment_count(receivers, num_segments, mask=mask)
    return torch.stack([fused[a] for a in aggregators], dim=1), count
