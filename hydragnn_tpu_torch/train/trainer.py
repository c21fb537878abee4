"""Train and eval steps (the reference's ``hydragnn_tpu/train/trainer.py``,
single device).

:func:`train_step` is the reference's ``_step_body``: a train-mode forward,
``multihead_rmse_loss``, the backward and the optimizer step, with metrics
weighted by the batch's real-graph count. :func:`eval_step` is
``make_eval_step`` under ``torch.inference_mode()``.

The non-finite guard (``guard=True``, the reference's ``_all_finite`` and
``_keep_if``): when the loss or any gradient is not finite, the step leaves
the parameters, the optimizer state and the batch norms' running statistics
as they were, its metrics carry zero weight and ``metrics["bad"]`` is 1.
The running statistics change in place during the forward, so the guarded
step copies them first and restores them on a bad step. The guarded step
syncs the host once per step (it reads the all-finite flag to decide
whether to call the optimizer); the unguarded step does not sync: its
metrics stay on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..graphs.batch import GraphBatch
from ..models.loss import multihead_rmse_loss


def loss_and_grads(
    model: nn.Module, batch: GraphBatch, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Train-mode forward and backward: ``(loss, per-head RMSE, one gradient
    per parameter in ``model.parameters()`` order)``. A parameter the loss
    does not reach gets zeros, as in ``jax.grad``. Updates the batch norms'
    running statistics. ``generator`` (on the model's device) draws GAT's
    attention dropout."""
    model.train()
    params = list(model.parameters())
    outputs = model(batch, generator)
    loss, rmses = multihead_rmse_loss(
        outputs, batch, model.output_type, model.task_weights
    )
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return loss.detach(), rmses.detach(), grads


def _all_finite(loss: torch.Tensor, grads: List[torch.Tensor]) -> torch.Tensor:
    """One device flag: the loss and every gradient are finite."""
    flags = [torch.isfinite(loss)] + [torch.isfinite(g).all() for g in grads]
    return torch.stack(flags).all()


def train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: GraphBatch,
    guard: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """One gradient step on ``batch``; returns the step's metrics as device
    tensors: ``loss`` and ``rmses`` weighted by ``count`` (real graphs), and
    with ``guard`` also ``bad`` (1.0 on a skipped step). ``generator`` draws
    the dropout (:func:`loss_and_grads`)."""
    stats = [b.detach().clone() for b in model.buffers()] if guard else None
    loss, rmses, grads = loss_and_grads(model, batch, generator)
    count = batch.count_real_graphs().to(torch.float32)
    if guard and not bool(_all_finite(loss, grads)):
        with torch.no_grad():
            for live, kept in zip(model.buffers(), stats):
                live.copy_(kept)
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return {
            "loss": zero,
            "rmses": torch.zeros_like(rmses),
            "count": zero,
            "bad": torch.ones((), dtype=torch.float32, device=loss.device),
        }
    for p, g in zip(model.parameters(), grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    metrics = {"loss": loss * count, "rmses": rmses * count, "count": count}
    if guard:
        metrics["bad"] = torch.zeros((), dtype=torch.float32, device=loss.device)
    return metrics


def eval_step(
    model: nn.Module, batch: GraphBatch
) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Eval-mode forward and loss: ``(metrics, outputs)``, metrics weighted
    by the real-graph count as in :func:`train_step`."""
    model.eval()
    with torch.inference_mode():
        outputs = model(batch)
        loss, rmses = multihead_rmse_loss(
            outputs, batch, model.output_type, model.task_weights
        )
        count = batch.count_real_graphs().to(torch.float32)
    return {"loss": loss * count, "rmses": rmses * count, "count": count}, outputs
