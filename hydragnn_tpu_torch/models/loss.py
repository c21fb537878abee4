"""Multi-task loss over padded batches (forward).

Total loss = Σ_i w_i · RMSE_i with the weights normalised to Σ|w| = 1; each
RMSE covers real rows only, through the batch masks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..graphs.batch import GraphBatch


def normalize_task_weights(weights: Sequence[float]) -> Tuple[float, ...]:
    total = sum(abs(w) for w in weights)
    return tuple(w / total for w in weights)


def head_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean squared error over rows where ``mask`` is True."""
    sq = (pred - target).square() * mask[:, None].to(pred.dtype)
    count = mask.sum().to(pred.dtype).clamp_min(1.0) * pred.shape[1]
    return sq.sum() / count


def multihead_rmse_loss(
    outputs: Sequence[torch.Tensor],
    batch: GraphBatch,
    output_type: Sequence[str],
    task_weights: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(total weighted loss, per-head RMSE [num_heads])``."""
    rmses = []
    total = 0.0
    for pred, target, htype, w in zip(outputs, batch.targets, output_type, task_weights):
        mask = batch.graph_mask if htype == "graph" else batch.node_mask
        # The floor keeps sqrt finite (and its gradient) at an exact-zero MSE.
        rmse = torch.sqrt(head_mse(pred, target, mask).clamp_min(1e-16))
        rmses.append(rmse)
        total = total + w * rmse
    return total, torch.stack(rmses)
