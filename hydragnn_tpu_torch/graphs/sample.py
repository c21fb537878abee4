"""Host-side graph sample (numpy only).

A ``GraphSample`` lives on the host, in the input pipeline. The collator
(``graphs/collate.py``) packs samples into padded numpy arrays, and
``GraphBatch.from_numpy`` moves those to the device. The packed ``y`` +
``y_loc`` layout is kept here and unpacked into dense per-head arrays at
batch time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class GraphSample:
    """One graph (atomic structure).

    x:    [n, F] node features.
    pos:  [n, 3] node positions.
    y:    packed target vector (graph features then per-head slices).
    y_loc: [1, num_heads+1] int64 prefix offsets of each head's slice in ``y``.
    edge_index: [2, E] int (senders row 0, receivers row 1).
    edge_attr:  [E, D] float edge attributes (e.g. lengths).
    supercell_size: [3, 3] lattice vectors for periodic structures.
    """

    x: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    y_loc: Optional[np.ndarray] = None
    edge_index: Optional[np.ndarray] = None
    edge_attr: Optional[np.ndarray] = None
    supercell_size: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        if self.x is not None:
            return int(self.x.shape[0])
        return int(self.pos.shape[0])

    @property
    def num_edges(self) -> int:
        if self.edge_index is None:
            return 0
        return int(self.edge_index.shape[1])

    def clone(self) -> "GraphSample":
        return GraphSample(
            **{
                f.name: (None if getattr(self, f.name) is None else np.array(getattr(self, f.name)))
                for f in dataclasses.fields(self)
            }
        )
