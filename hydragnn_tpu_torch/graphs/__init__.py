from .batch import GraphBatch
from .collate import (
    GraphArena,
    collate_graphs,
    compute_pad_sizes,
    round_up_pow2,
    unpack_targets,
)
from .csr import build_graph_ptr, build_row_ptr, validate_csr
from .sample import GraphSample

__all__ = [
    "GraphArena",
    "GraphBatch",
    "GraphSample",
    "build_graph_ptr",
    "build_row_ptr",
    "collate_graphs",
    "compute_pad_sizes",
    "round_up_pow2",
    "unpack_targets",
    "validate_csr",
]
