from .engine import (
    BackpressureError,
    EngineClosedError,
    EngineFailedError,
    InferenceEngine,
)

__all__ = [
    "BackpressureError",
    "EngineClosedError",
    "EngineFailedError",
    "InferenceEngine",
]
