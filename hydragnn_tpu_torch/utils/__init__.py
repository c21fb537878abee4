from .device import resolve_device
from .flax_weights import load_flax_variables
from .optimizer import (
    ReduceLROnPlateau,
    get_learning_rate,
    select_optimizer,
    set_learning_rate,
)

__all__ = [
    "ReduceLROnPlateau",
    "get_learning_rate",
    "load_flax_variables",
    "resolve_device",
    "select_optimizer",
    "set_learning_rate",
]
