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

The block-skip kernel K4 is the port of the reference's ``_skip_kernel``,
the variant ``_sum_count_pallas`` launches under ``HYDRAGNN_PALLAS_SKIP=1``:
the same function, with per-512-edge-block receiver ranges ``[lo, hi]``
over the kept ids and ``_block_overlap``'s predicate skipping every
(128-row node tile, edge block) pair that cannot meet. On a CUDA tensor
:func:`segment_sum_count_skip_forward` launches ``csrc/segment_skip.cu``
or raises; on a CPU tensor it runs :func:`segment_sum_count_skip_plain`,
which uses the same ranges and predicate. :func:`segment_sum_count_forward`
reads the switch (:func:`pallas_skip_enabled`) at every call and takes K4
when it is on, K2/K3 when it is off: the port runs eagerly, so this is its
counterpart of the reference's read at trace time.

The backward is the reference's ``_sum_count_bwd``, a gather:
``d_data[e] = d_sum[clip(ids[e], 0, N - 1)]`` for every row with
``id >= 0`` and 0 for the rest; the count has no gradient. So a row with
``id >= num_segments``, which the forward drops, gets the last segment's
cotangent, as in the reference (ROADMAP C3). No model path feeds such ids.
"""

from __future__ import annotations

import ctypes
import functools
import os
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
# Launches of the block-skip kernel (K4), counted likewise.
SKIP_LAUNCHES = 0
# The reference's edge block (_BE) and node block (_BN): K4 skips the same
# (node tile, edge block) pairs as the reference's _skip_kernel.
BLOCK_EDGES = 512
TILE_ROWS = 128


def pallas_skip_enabled() -> bool:
    """The reference's switch for the block-skip kernel
    (``HYDRAGNN_PALLAS_SKIP=1``; off by default), read at every call."""
    return os.environ.get("HYDRAGNN_PALLAS_SKIP", "0") not in ("0", "false", "False")


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
    stream; CPU tensors take the plain version. With the skip switch on,
    this is :func:`segment_sum_count_skip_forward`."""
    global KERNEL_LAUNCHES, WIDE_LAUNCHES
    if pallas_skip_enabled():
        return segment_sum_count_skip_forward(data, ids, num_segments)
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


def block_ranges(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` per block of ``BLOCK_EDGES`` ids: the least and the
    largest id ``>= 0`` of the block, or ``(2**31 - 1, -1)`` when the block
    keeps none (the reference's prefetched ranges)."""
    e = ids.shape[0]
    blocks = -(-e // BLOCK_EDGES)
    padded = torch.full((blocks * BLOCK_EDGES,), -1, dtype=torch.int32, device=ids.device)
    padded[:e] = ids
    padded = padded.view(blocks, BLOCK_EDGES)
    valid = padded >= 0
    lo = torch.where(valid, padded, torch.full_like(padded, 2**31 - 1)).amin(dim=1)
    hi = torch.where(valid, padded, torch.full_like(padded, -1)).amax(dim=1)
    return lo, hi


def block_overlap(lo: torch.Tensor, hi: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``[tiles, blocks]`` bools: the reference's ``_block_overlap`` for
    every (node tile of ``TILE_ROWS`` rows, edge block) pair."""
    tiles = -(-num_segments // TILE_ROWS)
    base = torch.arange(tiles, device=lo.device)[:, None] * TILE_ROWS
    return (hi[None, :] >= base) & (lo[None, :] < base + TILE_ROWS)


def segment_sum_count_skip_plain(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain PyTorch: the block ranges and the overlap
    predicate of the reference, then ``index_add_`` of the kept rows whose
    (tile, block) pair the predicate allows. Where the ranges are right, it
    allows every kept row, so this equals :func:`segment_sum_count_plain`."""
    total = torch.zeros(
        (num_segments, data.shape[1]), dtype=torch.float32, device=data.device
    )
    count = torch.zeros((num_segments,), dtype=torch.float32, device=data.device)
    if num_segments == 0 or ids.shape[0] == 0:
        return total, count
    lo, hi = block_ranges(ids)
    overlap = block_overlap(lo, hi, num_segments)
    kept = _kept(ids, num_segments)
    idx = torch.where(kept, ids, torch.zeros_like(ids)).long()
    block = torch.arange(ids.shape[0], device=ids.device) // BLOCK_EDGES
    allowed = kept & overlap[idx // TILE_ROWS, block]
    zero = torch.zeros((), dtype=torch.float32, device=data.device)
    total.index_add_(0, idx, torch.where(allowed[:, None], data, zero))
    count.index_add_(0, idx, allowed.to(torch.float32))
    return total, count


@functools.cache
def _skip_kernel():
    """``(entry point, edges per block, sub-blocks per block)`` of the built
    K4 library."""
    lib = _build.load("segment_skip")
    fn = lib.segment_skip_sum_count_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    for name in ("segment_skip_block_edges", "segment_skip_tile_rows", "segment_skip_sub_blocks"):
        getattr(lib, name).restype = ctypes.c_int
    if (lib.segment_skip_block_edges(), lib.segment_skip_tile_rows()) != (BLOCK_EDGES, TILE_ROWS):
        raise RuntimeError("segment_skip.cu's block sizes differ from the wrapper's")
    return fn, int(lib.segment_skip_sub_blocks())


def segment_sum_count_skip_forward(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_sum_count_forward`'s function through the block-skip
    kernel K4, without a gradient. CUDA tensors launch it on the current
    stream; CPU tensors take :func:`segment_sum_count_skip_plain`."""
    global SKIP_LAUNCHES
    _check(data, ids, num_segments)
    if data.device.type == "cpu":
        return segment_sum_count_skip_plain(data, ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    e, f = data.shape
    total = torch.empty((num_segments, f), dtype=torch.float32, device=data.device)
    count = torch.empty((num_segments,), dtype=torch.float32, device=data.device)
    if num_segments == 0:
        return total, count
    fn, subs = _skip_kernel()
    blocks = -(-e // BLOCK_EDGES)
    # Per block lo, hi, its row and count; per sub-block its row and count.
    iscratch = torch.empty((blocks * (4 + 2 * subs),), dtype=torch.int32, device=data.device)
    # The sums of the one-row sub-blocks and blocks.
    fscratch = torch.empty((blocks * (subs + 1), f), dtype=torch.float32, device=data.device)
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
            f"segment_skip launch failed with CUDA error {err} "
            f"(num_segments={num_segments}, E={e}, F={f})"
        )
    SKIP_LAUNCHES += 1
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
        # The reference's _sum_count_bwd: rows kept by id >= 0 alone, so a
        # row past the last segment gathers d_sum[N - 1] (ROADMAP C3).
        idx = ids.long().clamp(0, n - 1)
        zero = torch.zeros((), dtype=d_sum.dtype, device=d_sum.device)
        return torch.where((ids >= 0)[:, None], d_sum.index_select(0, idx), zero), None, None


def segment_sum_count(
    data: torch.Tensor, ids: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_sum_count_forward` (K2/K3, or K4 under the skip
    switch) with the reference's gather backward to ``data``
    (``_sum_count_bwd``: a row with ``id >= num_segments`` gathers the last
    segment's cotangent, ROADMAP C3)."""
    return _SegmentSumCount.apply(data, ids, num_segments)
