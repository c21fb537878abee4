"""Epoch loop: train, validate, test (the reference's
``hydragnn_tpu/train/train_validate_test.py``, single device, streamed).

Per epoch: ``set_epoch`` on every loader, one train pass, validation, test,
the plateau scheduler on the validation loss, and the history under the
reference's six keys. Each host batch is copied to the device once
(``GraphBatch.from_numpy``). Metrics are accumulated on the device and read
once per pass, so an epoch does not sync the host per step.

Not ported, and refused with ``NotImplementedError`` naming the ROADMAP
item: the scanned epoch and device-resident batch caches, meshes and data
parallelism (A5, A9), ``precision="bf16"`` (A7), fault drills (A8) and
checkpointing (A6), the non-finite guard's skip/rollback policy
(``fault_tolerance``, A8), the profiler, telemetry writers and the
visualizer (A6, A10). The guard itself is ported as ``train_step(...,
guard=True)``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..graphs.batch import GraphBatch
from ..utils.device import resolve_device
from ..utils.optimizer import ReduceLROnPlateau, get_learning_rate, set_learning_rate
from .trainer import eval_step, train_step


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class EpochMetrics:
    """Graph-count-weighted averages over a pass. The sums stay on the
    device until :meth:`averages` reads them."""

    def __init__(self):
        self.loss = None
        self.rmses = None
        self.count = None

    def update(self, metrics) -> None:
        if self.loss is None:
            self.loss = metrics["loss"].detach().clone()
            self.rmses = metrics["rmses"].detach().clone()
            self.count = metrics["count"].detach().clone()
        else:
            self.loss += metrics["loss"]
            self.rmses += metrics["rmses"]
            self.count += metrics["count"]

    def averages(self):
        if self.loss is None:
            return 0.0, []
        c = max(float(self.count), 1.0)
        return float(self.loss) / c, (self.rmses.cpu().numpy() / c).tolist()


class TrainingDriver:
    """Owns one model's training: the train pass and evaluation. ``model``
    and the optimizer's parameters must already be on ``device``."""

    def __init__(
        self,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        device="cuda",
        fault_tolerance: Optional[dict] = None,
        mesh=None,
        precision: Optional[str] = None,
        fault_plan=None,
        verbosity: int = 0,
    ):
        if mesh is not None:
            raise _unported("training on a device mesh (data or graph parallelism)", "A9")
        if precision not in (None, "f32", "fp32"):
            raise _unported(f"precision={precision!r}", "A7")
        if fault_plan is not None:
            raise _unported("fault drills (FaultPlan)", "A8")
        if fault_tolerance and fault_tolerance.get("enabled"):
            raise _unported("the guard's skip/rollback policy (fault_tolerance)", "A8")
        self.device = resolve_device(device)
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(
                    f"model parameter {name} is on {p.device}, not on {self.device}"
                )
        self.model = model
        self.optimizer = optimizer
        self.verbosity = verbosity

    def train_epoch(self, loader):
        """One pass over ``loader`` (host batches); returns ``(loss, per-head
        RMSE)`` averaged over real graphs."""
        metrics = EpochMetrics()
        for host in loader:
            batch = GraphBatch.from_numpy(host, self.device)
            metrics.update(train_step(self.model, self.optimizer, batch))
        return metrics.averages()

    def evaluate(self, loader, return_values: bool = False):
        """validate()/test(): ``(loss, per-head RMSE)``, and with
        ``return_values`` the per-head (true, predicted) arrays over real
        rows."""
        metrics = EpochMetrics()
        num_heads = len(self.model.output_type)
        true_values: List[List[np.ndarray]] = [[] for _ in range(num_heads)]
        pred_values: List[List[np.ndarray]] = [[] for _ in range(num_heads)]
        for host in loader:
            batch = GraphBatch.from_numpy(host, self.device)
            m, outputs = eval_step(self.model, batch)
            metrics.update(m)
            if return_values:
                for ih, (htype, out) in enumerate(zip(self.model.output_type, outputs)):
                    mask = host.graph_mask if htype == "graph" else host.node_mask
                    pred_values[ih].append(out.cpu().numpy()[mask])
                    true_values[ih].append(np.asarray(host.targets[ih])[mask])
        loss, rmses = metrics.averages()
        if return_values:
            tv = [np.concatenate(v) if v else np.zeros((0, 1)) for v in true_values]
            pv = [np.concatenate(v) if v else np.zeros((0, 1)) for v in pred_values]
            return loss, rmses, tv, pv
        return loss, rmses


def train_validate_test(
    driver: TrainingDriver,
    train_loader,
    val_loader,
    test_loader,
    num_epoch: int,
    writer=None,
    scheduler: Optional[ReduceLROnPlateau] = None,
    profiler=None,
    verbosity: int = 0,
    visualizer=None,
    checkpoint_name: Optional[str] = None,
    start_epoch: int = 0,
    history: Optional[dict] = None,
):
    """The epoch loop; returns the loss history dict (the reference's six
    keys)."""
    if writer is not None:
        raise _unported("telemetry writers (TensorBoard)", "A10")
    if profiler is not None:
        raise _unported("the profiler", "A10")
    if visualizer is not None:
        raise _unported("the visualizer", "A6")
    if checkpoint_name:
        raise _unported("checkpointing", "A6, A10b")
    history = history or {
        "total_loss_train": [],
        "total_loss_val": [],
        "total_loss_test": [],
        "task_loss_train": [],
        "task_loss_val": [],
        "task_loss_test": [],
    }
    for epoch in range(start_epoch, num_epoch):
        for loader in (train_loader, val_loader, test_loader):
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
        train_loss, train_rmses = driver.train_epoch(train_loader)
        val_loss, val_rmses = driver.evaluate(val_loader)
        test_loss, test_rmses = driver.evaluate(test_loader)
        if scheduler is not None:
            current_lr = get_learning_rate(driver.optimizer)
            new_lr = scheduler.step(val_loss, current_lr)
            if new_lr != current_lr:
                set_learning_rate(driver.optimizer, new_lr)
                if verbosity:
                    print(f"Epoch {epoch}: learning rate reduced to {new_lr}")
        if verbosity:
            print(
                f"Epoch: {epoch:4d}  Train: {train_loss:.8f}  "
                f"Val: {val_loss:.8f}  Test: {test_loss:.8f}"
            )
        history["total_loss_train"].append(train_loss)
        history["total_loss_val"].append(val_loss)
        history["total_loss_test"].append(test_loss)
        history["task_loss_train"].append(train_rmses)
        history["task_loss_val"].append(val_rmses)
        history["task_loss_test"].append(test_rmses)
    return history
