"""CSR segment reductions: the hand-written CUDA kernel and the fused ops on it.

:func:`csr_segment_sum_count` is the port of the reference's CSR run-walk
Pallas kernel (``hydragnn_tpu/ops/pallas_segment.py``: ``_csr_kernel``,
launched by ``_csr_sum_count_pallas``). Given destination-sorted data rows
and ``row_ptr [N + 1]`` it returns per row ``sum [N, F]`` over the run
``[row_ptr[n], row_ptr[n + 1])`` and ``count [N] = row_ptr[n + 1] -
row_ptr[n]``. On a CUDA tensor it launches ``csrc/csr_segment.cu`` (built by
``ops/_build.py``) or raises; on a CPU tensor it runs
:func:`csr_segment_sum_count_plain`. There is no other route.

Every call that carries ``row_ptr`` goes through it:

* :func:`fused_segment_sum_count`, :func:`fused_segment_sum`,
  :func:`fused_segment_mean` (the readout mean pool over ``graph_ptr``);
* :func:`fused_segment_stats`: pass 1 gives (sum, count) and the mean, pass 2
  sums the squared centred values, ``std = sqrt(sumsq / max(count, 1) +
  eps)`` (PNA's mean and std aggregators);
* :func:`pna_aggregate`, which adds min/max from :func:`segment_extrema`.

The fused ops take ``row_ptr`` always (the collator emits it for every
batch); a caller without CSR pointers uses ``ops/segment.py``. Under the CSR
contract masked rows are zeroed before the call and ids stay
raw: masked edges belong to padding segments, whose outputs nothing reads.
Forward only: serving runs under ``torch.inference_mode``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from . import segment as seg

# Launches of the CUDA kernel, counted by the wrapper at each launch and
# nowhere else. A run resets it to 0 and reads it after to show that a path
# went through the kernel.
KERNEL_LAUNCHES = 0


def _check(data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int) -> None:
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


def csr_segment_sum_count(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(sum [N, F] f32, count [N] f32)`` over the runs of
    ``row_ptr [N + 1]`` int32, ``N = num_segments``, for ``data [E, F]``
    float32 contiguous. ``row_ptr`` must satisfy the CSR contract
    (``graphs/csr.py``): non-decreasing, within ``[0, E]``. CUDA tensors
    launch the kernel on the current stream; CPU tensors take the plain
    version."""
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


def fused_segment_sum_count(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    row_ptr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked ``(segment_sum, segment_count)`` in one kernel call over
    ``row_ptr`` (the CSR contract: sorted raw ids, masked rows owned by
    padding segments); the count includes masked rows of padding segments.
    ``segment_ids`` is unused, kept for the reference's signature."""
    flat, unflatten = _flatten_trailing(data)
    flat = _zero_masked(flat, mask)
    total, count = csr_segment_sum_count(
        flat.to(torch.float32).contiguous(), row_ptr, num_segments
    )
    return unflatten(total.to(data.dtype)), count


def fused_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    row_ptr: torch.Tensor,
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
    row_ptr: torch.Tensor,
) -> torch.Tensor:
    """Masked ``segment_mean`` (the global mean-pool readout), in
    ``data.dtype``."""
    total, count = fused_segment_sum_count(
        data, segment_ids, num_segments, mask=mask, row_ptr=row_ptr
    )
    safe = seg._expand(count.clamp_min(1.0), total)
    return (total / safe).to(data.dtype)


def fused_segment_stats(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    want_std: bool = True,
    *,
    row_ptr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sum, mean, std, count)`` per segment of ``data [E, F]`` from two
    passes: (sum, count) gives ``mean = sum / max(count, 1)``; the second
    pass sums ``square(where(mask, x - mean[ids], 0))`` and
    ``std = sqrt(sumsq / max(count, 1) + eps)``. The centred form has no
    cancellation. ``want_std=False`` skips pass 2 (std comes back zero).
    Both passes are kernel calls over ``row_ptr``."""
    data = _zero_masked(data.to(torch.float32), mask)
    total, count = csr_segment_sum_count(data.contiguous(), row_ptr, num_segments)
    safe = count.clamp_min(1.0)[:, None]
    mean = total / safe
    if not want_std:
        return total, mean, torch.zeros_like(mean), count
    centered = _zero_masked(data - mean.index_select(0, segment_ids.long()), mask)
    sumsq, _ = csr_segment_sum_count(
        centered.square().contiguous(), row_ptr, num_segments
    )
    std = torch.sqrt(sumsq / safe + eps)
    return total, mean, std, count


def segment_extrema(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min, max)`` per segment; ``ids < 0`` marks masked rows and empty
    segments yield 0. Plain ``scatter_reduce`` (``ops/segment.py``)."""
    mask = ids >= 0
    safe_ids = torch.where(mask, ids, torch.zeros_like(ids))
    mn = seg.segment_min(data, safe_ids, num_segments, mask=mask)
    mx = seg.segment_max(data, safe_ids, num_segments, mask=mask)
    return mn, mx


def pna_aggregate(
    msg: torch.Tensor,
    receivers: torch.Tensor,
    num_segments: int,
    aggregators: Sequence[str],
    mask: Optional[torch.Tensor] = None,
    *,
    row_ptr: torch.Tensor,
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
