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

:func:`csr_segment_stats` is K5, the PNA stats bundle in one launch
(``csrc/csr_stats.cu``; it replaces the reference's
``_stats_forward_pallas`` on the CSR route, two ``_csr_kernel`` passes,
and ``segment_extrema``): per segment sum, count, mean, the centred std and
min/max, with the reference's backwards ``_stats_bwd`` and
``_extrema_bwd``. Its plain version :func:`csr_segment_stats_plain` is the
two-pass code plus ``scatter_reduce`` min/max.

The fused ops take the reference's routes (``_sorted_route``):

* with ``row_ptr`` (the CSR contract: sorted raw ids, masked rows zeroed and
  owned by padding segments) every (sum, count) is
  :func:`csr_segment_sum_count` and the stats are K5;
* without it (``row_ptr=None``) masked rows get id -1 and every pass is
  ``ops/segment_sum_count.py``'s unsorted-id kernel, which leaves them out
  (or its block-skip kernel, under ``HYDRAGNN_PALLAS_SKIP=1``), with min/max
  from :func:`segment_extrema` (plain ``scatter_reduce``).

The ops are :func:`fused_segment_sum_count`, :func:`fused_segment_sum`,
:func:`fused_segment_mean` (the readout mean pool), :func:`fused_segment_stats`
(``(sum, mean, std, count)``, ``std = sqrt(Σ(x - mean)² / max(count, 1) +
eps)``, with the reference's analytic backward ``_stats_bwd``) and
:func:`pna_aggregate`, which adds min and max (the reference's
``_extrema_bwd``: every row equal to its segment's extremum receives the
full cotangent).
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
# The same for K5, the CSR stats kernel (csr_segment_stats_forward).
STATS_LAUNCHES = 0


def _check(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int, ids=None,
    dtypes=(torch.float32,),
) -> None:
    if data.dim() != 2:
        raise ValueError(f"data must be [E, F], got shape {tuple(data.shape)}")
    if data.dtype not in dtypes:
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
        (num_segments, data.shape[1]), dtype=data.dtype, device=data.device
    )
    total.index_add_(0, ids, data[start : start + ids.shape[0]])
    return total, counts.to(torch.float32)


def _scratch_query(lib):
    query = lib.csr_lanes_scratch
    query.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    query.restype = None
    return query


def _sizer(query, parts: int):
    """``(e, f, vec4) -> (scratch floats, ticket ints)`` of one call with
    ``parts`` partial rows per slot, from the library's own layout
    (``csrc/csr_lanes.cuh``), cached per shape."""

    @functools.lru_cache(maxsize=256)
    def sizes(e: int, f: int, vec4: bool) -> Tuple[int, int]:
        out = (ctypes.c_longlong * 2)()
        query(e, f, int(vec4), parts, out)
        return int(out[0]), int(out[1])

    return sizes


@functools.cache
def _kernel():
    """``(entry point, scratch sizes)`` of K1's built library."""
    lib = _build.load("csr_segment")
    fn = lib.csr_segment_sum_count_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, _sizer(_scratch_query(lib), 1)


@functools.cache
def _stats_kernel():
    """``(entry point, scratch sizes)`` of K5's built library."""
    lib = _build.load("csr_stats")
    fn = lib.csr_segment_stats_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                  ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, _sizer(_scratch_query(lib), 4)


# Tickets of the kernels' tree merges (csr_lanes.cuh), one zeroed int32
# buffer per (device, stream): each launch leaves the tickets it drew at
# zero again, and launches on one stream never overlap.
_TICKETS = {}


def _tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    buf = _TICKETS.get((device, stream))
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = buf
    return buf


def _launch(device: torch.device, stream: int, fn, args, what: str, shape: str) -> None:
    """``fn(*args, stream)`` on ``device``; raises if the launch reports a
    CUDA error."""
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err} ({shape})")


def csr_segment_sum_count_forward(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(sum [N, F] f32, count [N] f32)`` over the runs of
    ``row_ptr [N + 1]`` int32, ``N = num_segments``, for ``data [E, F]``
    float32 contiguous, without a gradient. ``row_ptr`` must satisfy the
    CSR contract (``graphs/csr.py``): non-decreasing, within ``[0, E]``.
    CUDA tensors launch the kernel (one launch) on the current stream; CPU
    tensors take the plain version."""
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
    fn, sizes = _kernel()
    vec4 = f % 4 == 0 and data.data_ptr() % 16 == 0
    floats, tickets = sizes(e, f, vec4)
    # The partials of the pieces of runs longer than one chunk.
    scratch = torch.empty((floats,), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    _launch(
        data.device, stream, fn,
        (data.data_ptr(), row_ptr.data_ptr(), total.data_ptr(), count.data_ptr(),
         scratch.data_ptr(), _tickets(data.device, stream, tickets).data_ptr(),
         num_segments, e, f, int(vec4)),
        "csr_segment_sum_count", f"num_segments={num_segments}, E={e}, F={f}",
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


def _check_mask(mask: Optional[torch.Tensor], data: torch.Tensor) -> None:
    if mask is None:
        return
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if tuple(mask.shape) != (data.shape[0],):
        raise ValueError(
            f"mask must have one entry per data row ({data.shape[0]}), got shape "
            f"{tuple(mask.shape)}"
        )
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if mask.device != data.device:
        raise ValueError(f"data on {data.device} but mask on {mask.device}")


def _stats_dtypes(data: torch.Tensor):
    """What K5's wrappers compute in: float32, or on the CPU also float64
    (the plain version, for an f64 reference step)."""
    if data.device.type == "cpu" and data.dtype == torch.float64:
        return (torch.float32, torch.float64)
    return (torch.float32,)


def csr_segment_stats_plain(
    data: torch.Tensor,
    mask: Optional[torch.Tensor],
    row_ptr: torch.Tensor,
    num_segments: int,
    eps: float = 1e-5,
    want_std: bool = True,
    want_extrema: bool = True,
):
    """K5's function in plain PyTorch: the two (sum, count) passes of the
    stats (masked rows zeroed, counted in their segment) and ``scatter_reduce``
    min/max over the rows ``mask`` keeps (``ops/segment.py``)."""
    zeroed = _zero_masked(data, mask)
    total, count = csr_segment_sum_count_plain(zeroed, row_ptr, num_segments)
    safe = count.clamp_min(1.0)[:, None]
    mean = total / safe
    start, stop = int(row_ptr[0]), int(row_ptr[-1])
    ids = torch.repeat_interleave(
        torch.arange(num_segments, device=data.device), row_ptr.diff().long()
    )
    if want_std:
        centered = zeroed[start:stop] - mean.index_select(0, ids)
        sumsq, _ = csr_segment_sum_count_plain(
            centered.square().contiguous(), row_ptr - start, num_segments
        )
        std = torch.sqrt(sumsq / safe + eps)
    else:
        std = torch.zeros_like(mean)
    if not want_extrema:
        return total, mean, std, count, None, None
    rows = data[start:stop]
    keep = None if mask is None else mask[start:stop]
    mn = seg.segment_min(rows, ids, num_segments, mask=keep)
    mx = seg.segment_max(rows, ids, num_segments, mask=keep)
    return total, mean, std, count, mn, mx


def csr_segment_stats_forward(
    data: torch.Tensor,
    mask: Optional[torch.Tensor],
    row_ptr: torch.Tensor,
    num_segments: int,
    eps: float = 1e-5,
    want_std: bool = True,
    want_extrema: bool = True,
):
    """Per segment of ``data [E, F]`` float32 over the runs of ``row_ptr``
    (the CSR contract): ``(sum, mean, std, count, min, max)``, without a
    gradient. Masked rows (``mask [E]`` bool False) are zeroed in the sum and
    the centred sum of squares and counted; min and max leave them out and
    are 0 where a segment keeps no row (``None`` unless ``want_extrema``);
    ``mean = sum / max(count, 1)``, ``std = sqrt(Σ(x - mean)² / max(count,
    1) + eps)`` (zeros unless ``want_std``). CUDA tensors launch K5 (one
    launch, ``csrc/csr_stats.cu``) on the current stream; CPU tensors take
    :func:`csr_segment_stats_plain`."""
    global STATS_LAUNCHES
    _check(data, row_ptr, num_segments, dtypes=_stats_dtypes(data))
    _check_mask(mask, data)
    if data.device.type == "cpu":
        return csr_segment_stats_plain(
            data, mask, row_ptr, num_segments, eps, want_std, want_extrema
        )
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    e, f = data.shape
    outs = [
        torch.empty((num_segments, f), dtype=torch.float32, device=data.device)
        for _ in range(5 if want_extrema else 3)
    ]
    count = torch.empty((num_segments,), dtype=torch.float32, device=data.device)
    total, mean, std = outs[:3]
    mn, mx = outs[3:] if want_extrema else (None, None)
    if num_segments == 0:
        return total, mean, std, count, mn, mx
    fn, sizes = _stats_kernel()
    vec4 = f % 4 == 0 and data.data_ptr() % 16 == 0
    floats, tickets = sizes(e, f, vec4)
    # The (sum, M2, min, max) partials of the pieces of long runs.
    scratch = torch.empty((floats,), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    _launch(
        data.device, stream, fn,
        (data.data_ptr(), 0 if mask is None else mask.data_ptr(), row_ptr.data_ptr(),
         total.data_ptr(), mean.data_ptr(), std.data_ptr(), count.data_ptr(),
         0 if mn is None else mn.data_ptr(), 0 if mx is None else mx.data_ptr(),
         scratch.data_ptr(), _tickets(data.device, stream, tickets).data_ptr(),
         num_segments, e, f, int(vec4), float(eps), int(want_std)),
        "csr_segment_stats", f"num_segments={num_segments}, E={e}, F={f}",
    )
    STATS_LAUNCHES += 1
    return total, mean, std, count, mn, mx


def _stats_grad(data, keep, idx, mean, std, count, d_total, d_mean, d_std, want_std):
    """The reference's ``_stats_bwd``: the cotangent of ``data [E, F]`` from
    those of the per-segment sum, mean and std. ``idx [E]`` is each row's
    segment, ``keep [E]`` bool the rows that took part. With ``s = Σx``,
    ``μ = s / n`` and ``σ = sqrt(Σ(x − μ)² / n + eps)``, ``Σ_e (x_e − μ) = 0``
    removes the μ-coupling inside σ, so ``dx_e = ds + dμ / n + dσ·(x_e − μ) /
    (σ·n)`` at the row's segment, with dσ taken as 0 where ``count <= 1``
    (there ``x ≡ μ``; this keeps the ``1 / sqrt(eps)`` factor off rounding
    residue), and 0 on the rows ``keep`` drops."""
    safe = count.clamp_min(1.0)[:, None]
    d_data = (d_total + d_mean / safe).index_select(0, idx)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if want_std:
        per_seg_quad = torch.where(count[:, None] > 1.0, d_std / (std * safe), zero)
        d_data = d_data + per_seg_quad.index_select(0, idx) * (
            data - mean.index_select(0, idx)
        )
    return torch.where(keep[:, None], d_data, zero)


def _extrema_grad(data, keep, idx, mn, mx, d_mn, d_mx):
    """The reference's ``_extrema_bwd``: every kept row equal to its
    segment's min (max) receives the full min (max) cotangent."""
    kept = keep[:, None]
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return torch.where(
        kept & (data == mn.index_select(0, idx)), d_mn.index_select(0, idx), zero
    ) + torch.where(
        kept & (data == mx.index_select(0, idx)), d_mx.index_select(0, idx), zero
    )


class _CsrStats(torch.autograd.Function):
    """K5's forward with the reference's backwards, :func:`_stats_grad` for
    sum, mean and std and :func:`_extrema_grad` for min and max, over the
    kernel's saved mean, std, count, min and max; masked rows and rows whose
    id is negative get 0."""

    @staticmethod
    def forward(ctx, data, mask, ids, row_ptr, num_segments, eps, want_std, want_extrema):
        total, mean, std, count, mn, mx = csr_segment_stats_forward(
            data, mask, row_ptr, num_segments, eps, want_std, want_extrema
        )
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(data, mask, ids, mean, std, count, mn, mx)
        ctx.num_segments = num_segments
        ctx.want_std = want_std
        return total, mean, std, count, mn, mx

    @staticmethod
    def backward(ctx, d_total, d_mean, d_std, d_count, d_mn, d_mx):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        data, mask, ids, mean, std, count, mn, mx = ctx.saved_tensors
        idx = _clipped(ids, ctx.num_segments)
        keep = ids >= 0 if mask is None else mask & (ids >= 0)
        d_data = _stats_grad(
            data, keep, idx, mean, std, count, d_total, d_mean, d_std, ctx.want_std
        )
        if mn is not None:
            d_data = d_data + _extrema_grad(data, keep, idx, mn, mx, d_mn, d_mx)
        return (d_data,) + (None,) * 7


def csr_segment_stats(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    want_std: bool = True,
    want_extrema: bool = True,
    *,
    row_ptr: torch.Tensor,
):
    """:func:`csr_segment_stats_forward` (K5) with the reference's
    backwards to ``data``: ``(sum, mean, std, count, min, max)`` per segment,
    min and max ``None`` unless ``want_extrema``. ``segment_ids [E]`` are the
    raw sorted ids of the rows (the backward gathers through them)."""
    data = data.to(_stats_dtypes(data)[-1]).contiguous()
    _check(data, row_ptr, num_segments, segment_ids, dtypes=_stats_dtypes(data))
    if mask is not None:
        mask = mask.contiguous()
    return _CsrStats.apply(
        data, mask, segment_ids, row_ptr, num_segments, eps, want_std, want_extrema
    )


class _Stats(torch.autograd.Function):
    """The reference's ``_stats`` on the unsorted-id kernel (batches
    without CSR pointers), two (sum, count) passes, with the same analytic
    backward ``_stats_bwd`` as :class:`_CsrStats`."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, eps, want_std):
        total, count = ssc.segment_sum_count_forward(data, ids, num_segments)
        safe = count.clamp_min(1.0)[:, None]
        mean = total / safe
        if want_std:
            idx = _clipped(ids, num_segments)
            zero = torch.zeros((), dtype=data.dtype, device=data.device)
            centered = torch.where(
                (ids >= 0)[:, None], data - mean.index_select(0, idx), zero
            )
            sumsq, _ = ssc.segment_sum_count_forward(
                centered.square().contiguous(), ids, num_segments
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
            return None, None, None, None, None
        data, ids, mean, std, count = ctx.saved_tensors
        d_data = _stats_grad(
            data, ids >= 0, _clipped(ids, ctx.num_segments), mean, std, count,
            d_total, d_mean, d_std, ctx.want_std,
        )
        return d_data, None, None, None, None


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
    """``(sum, mean, std, count)`` per segment of ``data [E, F]``: ``mean =
    sum / max(count, 1)``, ``std = sqrt(Σ(x - mean)² / max(count, 1) + eps)``
    over the centred values (no cancellation). ``want_std=False`` skips the
    centred pass (std comes back zero). With ``row_ptr`` one launch of K5
    (:func:`csr_segment_stats`: masked rows zeroed, ids raw, the CSR
    contract); without it two passes of the unsorted-id kernel with masked
    rows at id -1."""
    if row_ptr is not None:
        return csr_segment_stats(
            data, segment_ids, num_segments, mask, eps, want_std, False, row_ptr=row_ptr
        )[:4]
    data = data.to(torch.float32)
    ids = _masked_ids(segment_ids, mask)
    return _Stats.apply(data.contiguous(), ids, num_segments, eps, want_std)


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
        d_data = _extrema_grad(
            data, ids >= 0, _clipped(ids, ctx.num_segments), mn, mx, d_mn, d_mx
        )
        return d_data, None, None


def segment_extrema(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min, max)`` per segment; ``ids < 0`` marks masked rows and empty
    segments yield 0. Plain ``scatter_reduce`` (``ops/segment.py``) with the
    reference's subgradient backward (``_extrema_bwd``): the route of
    batches without CSR pointers (with them K5 gives min and max)."""
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
    """PNA multi-aggregator bundle → ``(stacked [N, A, F], count [N])``.
    With ``row_ptr`` sum/mean/std and min/max come from one launch of K5
    (:func:`csr_segment_stats`); without it from :func:`fused_segment_stats`
    (two unsorted-id kernel passes) and :func:`segment_extrema`."""
    fused = {}
    count = None
    want_stats = any(a in ("mean", "std", "sum") for a in aggregators)
    want_extrema = "min" in aggregators or "max" in aggregators
    if row_ptr is not None and (want_stats or want_extrema):
        total, mean, std, stats_count, mn, mx = csr_segment_stats(
            msg, receivers, num_segments, mask, want_std="std" in aggregators,
            want_extrema=want_extrema, row_ptr=row_ptr,
        )
        if want_stats:
            fused.update(mean=mean, std=std, sum=total)
            count = stats_count
        if want_extrema:
            fused.update(min=mn, max=mx)
    elif row_ptr is None:
        if want_stats:
            total, mean, std, count = fused_segment_stats(
                msg, receivers, num_segments, mask=mask, want_std="std" in aggregators,
            )
            fused.update(mean=mean, std=std, sum=total)
        if want_extrema:
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
