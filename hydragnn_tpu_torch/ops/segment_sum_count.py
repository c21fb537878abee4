"""Segment (sum, count) over unsorted ids: the hand-written CUDA kernel for
batches without CSR pointers.

:func:`segment_sum_count` is the port of the reference's one-hot Pallas
kernels (``hydragnn_tpu/ops/pallas_segment.py``: ``_sum_count_kernel`` and
``_sum_count_split_kernel``, launched by ``_sum_count_pallas``; entry
``segment_sum_count``). Given ``data [E, F]`` float32 and ``ids [E]`` int32
it returns ``sum [N, F]`` and ``count [N]`` per segment ``n <
num_segments``; rows whose id is negative (masked) or ``>= num_segments``
are left out of both, and empty segments yield 0. On a CUDA tensor the
forward launches ``csrc/segment_sum_count.cu`` (built by ``ops/_build.py``)
or raises; on a CPU tensor it runs :func:`segment_sum_count_plain`. The
reference has two kernels because its MXU rounds operands to bf16 (a hi/lo
split, packed into 128 lanes at F <= 64); the card adds f32 natively, so
one kernel serves every width. Its launches at F > 64, the reference's
``_sum_count_split_kernel`` shapes, are also counted apart.

The backward is the reference's ``_sum_count_bwd``, a gather:
``d_data[e] = d_sum[ids[e]]`` for kept rows and 0 for the rest; the count
has no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

# Launches of the CUDA kernel, counted by the wrapper at each launch and
# nowhere else, and of those the launches at F > WIDE_F. A run resets both
# to 0 and reads them after to show that a path went through the kernel.
KERNEL_LAUNCHES = 0
WIDE_LAUNCHES = 0
# Widest rows that the reference packs into one 128-lane tile (2F <= 128).
WIDE_F = 64


def _check(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> None:
    if data.dim() != 2:
        raise ValueError(f"data must be [E, F], got shape {tuple(data.shape)}")
    if data.dtype != torch.float32:
        raise TypeError(f"data must be float32, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if tuple(ids.shape) != (data.shape[0],):
        raise ValueError(
            f"ids must have one entry per data row ({data.shape[0]}), got "
            f"shape {tuple(ids.shape)}"
        )
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if data.device != ids.device:
        raise ValueError(f"data on {data.device} but ids on {ids.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if max(3 * num_segments + 1 + data.shape[0], data.shape[1]) >= 2**31:
        raise ValueError("sizes must fit a 32-bit int")


def _kept(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_segments)


def segment_sum_count_plain(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``index_add_`` of the kept
    rows."""
    total = torch.zeros(
        (num_segments, data.shape[1]), dtype=torch.float32, device=data.device
    )
    count = torch.zeros((num_segments,), dtype=torch.float32, device=data.device)
    if num_segments == 0:
        return total, count
    kept = _kept(ids, num_segments)
    idx = torch.where(kept, ids, torch.zeros_like(ids)).long()
    zero = torch.zeros((), dtype=torch.float32, device=data.device)
    total.index_add_(0, idx, torch.where(kept[:, None], data, zero))
    count.index_add_(0, idx, kept.to(torch.float32))
    return total, count


@functools.cache
def _kernel():
    """``(entry point, edges per chunk)`` of the built library."""
    lib = _build.load("segment_sum_count")
    fn = lib.segment_sum_count_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.segment_sum_count_chunk_edges.restype = ctypes.c_int
    return fn, int(lib.segment_sum_count_chunk_edges())


def segment_sum_count_forward(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment ``(sum [N, F] f32, count [N] f32)``, ``N =
    num_segments``, of ``data [E, F]`` float32 contiguous over ``ids [E]``
    int32, without a gradient. CUDA tensors launch the kernel on the current
    stream; CPU tensors take the plain version."""
    global KERNEL_LAUNCHES, WIDE_LAUNCHES
    _check(data, ids, num_segments)
    if data.device.type == "cpu":
        return segment_sum_count_plain(data, ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    e, f = data.shape
    total = torch.empty((num_segments, f), dtype=torch.float32, device=data.device)
    count = torch.empty((num_segments,), dtype=torch.float32, device=data.device)
    if num_segments == 0:
        return total, count
    fn, chunk = _kernel()
    # Counts, offsets, cursors and the permutation; the walk's partials.
    iscratch = torch.empty(
        (3 * num_segments + 1 + e,), dtype=torch.int32, device=data.device
    )
    fscratch = torch.empty(
        (2, -(-e // chunk), f), dtype=torch.float32, device=data.device
    )
    vec4 = f % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (data, total, fscratch)
    )
    with torch.cuda.device(data.device):
        err = fn(
            data.data_ptr(), ids.data_ptr(), total.data_ptr(),
            count.data_ptr(), iscratch.data_ptr(), fscratch.data_ptr(),
            num_segments, e, f, int(vec4),
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"segment_sum_count launch failed with CUDA error {err} "
            f"(num_segments={num_segments}, E={e}, F={f})"
        )
    KERNEL_LAUNCHES += 1
    if f > WIDE_F:
        WIDE_LAUNCHES += 1
    return total, count


class _SegmentSumCount(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        total, count = segment_sum_count_forward(data, ids, num_segments)
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return total, count

    @staticmethod
    def backward(ctx, d_sum, d_count):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        n = ctx.num_segments
        if n == 0:
            return d_sum.new_zeros((ids.shape[0], d_sum.shape[1])), None, None
        kept = _kept(ids, n)
        idx = torch.where(kept, ids, torch.zeros_like(ids)).long()
        zero = torch.zeros((), dtype=d_sum.dtype, device=d_sum.device)
        return torch.where(kept[:, None], d_sum.index_select(0, idx), zero), None, None


def segment_sum_count(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_sum_count_forward` with the reference's gather
    backward to ``data`` (``_sum_count_bwd``)."""
    return _SegmentSumCount.apply(data, ids, num_segments)
