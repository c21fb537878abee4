from .base import HydraGNN
from .create import create_model
from .loss import multihead_rmse_loss

__all__ = ["HydraGNN", "create_model", "multihead_rmse_loss"]
