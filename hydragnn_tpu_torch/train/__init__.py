from .train_validate_test import EpochMetrics, TrainingDriver, train_validate_test
from .trainer import eval_step, loss_and_grads, train_step

__all__ = [
    "EpochMetrics",
    "TrainingDriver",
    "eval_step",
    "loss_and_grads",
    "train_step",
    "train_validate_test",
]
