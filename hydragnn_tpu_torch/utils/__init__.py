from .device import resolve_device
from .flax_weights import load_flax_variables

__all__ = ["resolve_device", "load_flax_variables"]
