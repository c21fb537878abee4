"""Masked segment ops in plain PyTorch.

Each op takes a static ``num_segments`` and an optional boolean ``mask`` over
the data rows. Sums go through ``index_add_``, extrema through
``scatter_reduce(..., include_self=False)``. These are the port's
counterpart of the reference's XLA segment ops (not kernels): the model's
sums, means and stds go through ``ops/csr_segment.py`` (the kernels, with
or without ``row_ptr``) instead, and so do PNA's min and max with
``row_ptr`` (K5); its min and max without ``row_ptr``, K5's plain version
and GAT's softmax shift come from here.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e30


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a [N] mask against [N, ...] data."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _rows_index(segment_ids: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """int64 ids broadcast to ``like``'s shape, for ``scatter_reduce``."""
    ids = segment_ids.long()
    return _expand(ids, like).expand_as(like)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if mask is not None:
        data = torch.where(_expand(mask, data), data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, torch.zeros_like(ones))
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask)
    return total / _expand(count.clamp_min(1.0), total)


def _segment_extreme(data, segment_ids, num_segments, mask, fill, reduce):
    big = -_BIG if reduce == "amax" else _BIG
    if mask is not None:
        data = torch.where(_expand(mask, data), data, torch.full((), big, dtype=data.dtype, device=data.device))
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), big, dtype=data.dtype, device=data.device
    )
    out = out.scatter_reduce(
        0, _rows_index(segment_ids, data), data, reduce, include_self=False
    )
    # Empty segments keep the ±BIG start value: replace with ``fill`` so
    # downstream matmuls stay finite (isolated nodes have no messages).
    empty = out <= -_BIG / 2 if reduce == "amax" else out >= _BIG / 2
    return torch.where(empty, torch.full((), fill, dtype=out.dtype, device=out.device), out)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    fill: float = 0.0,
) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, mask, fill, "amax")


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    fill: float = 0.0,
) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, mask, fill, "amin")


def segment_std(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Per-segment ``sqrt(relu(E[x^2] - E[x]^2) + eps)`` (PyG's PNA ``std``)."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    mean_sq = segment_mean(data.square(), segment_ids, num_segments, mask)
    return torch.sqrt(torch.relu(mean_sq - mean.square()) + eps)


def masked_mean(data: torch.Tensor, mask: torch.Tensor, axis=None) -> torch.Tensor:
    """Mean over rows where ``mask`` is True."""
    m = _expand(mask, data).expand_as(data).to(data.dtype)
    dims = tuple(range(data.dim())) if axis is None else axis
    total = (data * m).sum(dim=dims)
    count = m.sum(dim=dims)
    return total / count.clamp_min(1.0)
