"""Optimizer selection with the reference's semantics
(``hydragnn_tpu/utils/optimizer.py``, which maps the names to optax).

``select_optimizer(model, name, learning_rate, freeze_conv)`` returns a
``torch.optim`` optimizer configured to compute what the reference's optax
transformation computes, not what torch's defaults would:

* ``sgd``: ``optax.sgd(lr)``, plain ``p -= lr * g`` (no momentum);
* ``adam``: ``optax.adam(lr)``, b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias-corrected moments, no weight decay;
* ``adamw``: ``optax.adamw(lr, weight_decay=0.01)``, Adam plus the
  decoupled decay ``-lr * 0.01 * p`` on the pre-update parameters.

The learning rate is held as the nearest float32, as optax's injected
hyperparameter is, so that the plateau scheduler sees the same values.
``freeze_conv`` leaves the encoder's ``conv_*``/``bn_*`` parameters out of
the optimizer: no update and no weight decay, like the reference's
``set_to_zero`` partition. The train step hands every parameter a gradient
(zeros where the loss does not reach it), as optax always receives one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

# Reference names the port does not carry yet, each with its ROADMAP item.
_NOT_PORTED = {
    "adadelta": "A5",
    "adagrad": "A5",
    "adamax": "A5",
    "rmsprop": "A5",
    "sparseadam": "A5",
    "lbfgs": "A5 (LBFGS: optax's zoom linesearch)",
}


def _f32(value: float) -> float:
    return float(np.float32(value))


def _trainable(model: nn.Module, freeze_conv: bool):
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        if freeze_conv and (top.startswith("conv_") or top.startswith("bn_")):
            continue
        yield p


def select_optimizer(
    model: nn.Module,
    name: str,
    learning_rate: float,
    freeze_conv: bool = False,
) -> torch.optim.Optimizer:
    """The optimizer ``name`` (case-insensitive) over ``model``'s
    parameters."""
    name_l = name.lower()
    if name_l in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP {_NOT_PORTED[name_l]}); "
            "ported: sgd, adam, adamw"
        )
    lr = _f32(learning_rate)
    params = list(_trainable(model, freeze_conv))
    if name_l == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.0, weight_decay=0.0)
    if name_l == "adam":
        return torch.optim.Adam(
            params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0
        )
    if name_l == "adamw":
        # torch's AdamW default weight_decay is 0.01 too, but optax's is 1e-4:
        # the reference pins 0.01, so it is pinned here as well.
        return torch.optim.AdamW(
            params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
        )
    raise ValueError(f"Purpose of {name} optimizer is not defined.")


def get_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    """The current learning rate (every group carries the same one)."""
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every group, in place, as float32."""
    for group in optimizer.param_groups:
        group["lr"] = _f32(lr)


class ReduceLROnPlateau:
    """Host-side plateau scheduler with torch's decision semantics, as the
    reference keeps it: factor 0.5, patience 5, min_lr 1e-5 by default,
    relative improvement threshold 1e-4, cooldown 0; stepped on the
    validation loss every epoch."""

    def __init__(
        self,
        factor=0.5,
        patience=5,
        min_lr=1e-5,
        mode="min",
        threshold=1e-4,
        threshold_mode="rel",
        cooldown=0,
    ):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            eps = (
                1.0 - self.threshold
                if self.mode == "min"
                else 1.0 + self.threshold
            )
            bar = self.best * eps
        else:  # "abs"
            bar = (
                self.best - self.threshold
                if self.mode == "min"
                else self.best + self.threshold
            )
        return metric < bar if self.mode == "min" else metric > bar

    def step(self, metric: float, current_lr: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            self.cooldown_counter = self.cooldown
            return max(current_lr * self.factor, self.min_lr)
        return current_lr

    def state_dict(self) -> dict:
        """Mutable decision state; hyperparameters come from the config."""
        return {
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.num_bad_epochs = int(state["num_bad_epochs"])
        self.cooldown_counter = int(state["cooldown_counter"])
