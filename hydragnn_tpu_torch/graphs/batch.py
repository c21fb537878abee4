"""Padded, statically shaped graph batch.

The collator (``graphs/collate.py``) fills a ``GraphBatch`` with numpy arrays
on the host; :meth:`GraphBatch.from_numpy` moves one to the device as
tensors, in one host-to-device copy per field.

* ``G`` real graphs are packed into fixed-size node/edge/graph arrays
  ``(num_nodes_pad, num_edges_pad, num_graphs_pad)``.
* At least one padding node and one padding graph are always reserved; every
  padding edge connects padding node to padding node, so message passing runs
  unmasked and garbage lands only on padding rows, which the masks exclude
  from batch-norm statistics, pooling denominators and the loss.
* Targets are dense per head: graph heads ``[num_graphs_pad, dim]``, node
  heads ``[num_nodes_pad, dim]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class GraphBatch:
    """A fixed-shape batch of graphs, as numpy arrays (host) or tensors.

    Attributes:
      node_features:  [N_pad, F] float32 (padding rows zero).
      edge_features:  [E_pad, D] float32 or None.
      senders:        [E_pad] int32 source node of each edge.
      receivers:      [E_pad] int32 destination node, non-decreasing.
      node_graph:     [N_pad] int32 graph id of each node.
      node_mask:      [N_pad] bool, True for real nodes.
      edge_mask:      [E_pad] bool, True for real edges.
      graph_mask:     [G_pad] bool, True for real graphs.
      targets:        one entry per head ([G_pad, dim] or [N_pad, dim]).
      row_ptr:        [N_pad + 1] int32 CSR boundaries over ``receivers``,
                      or None: the segment ops then take the unsorted-id
                      kernel (``ops/segment_sum_count.py``).
      graph_ptr:      [G_pad + 1] int32 CSR boundaries over ``node_graph``,
                      or None, likewise.
      num_graphs_pad: plain int (G_pad).
    """

    node_features: Any
    edge_features: Optional[Any]
    senders: Any
    receivers: Any
    node_graph: Any
    node_mask: Any
    edge_mask: Any
    graph_mask: Any
    targets: Tuple[Any, ...] = ()
    row_ptr: Optional[Any] = None
    graph_ptr: Optional[Any] = None
    num_graphs_pad: int = 0

    @property
    def num_nodes_pad(self) -> int:
        return int(self.node_features.shape[0])

    @property
    def num_edges_pad(self) -> int:
        return int(self.senders.shape[0])

    def count_real_graphs(self):
        """Number of real graphs (``graph_mask`` set), on the batch's device."""
        return self.graph_mask.sum()

    def _map(self, fn) -> "GraphBatch":
        def opt(v):
            return None if v is None else fn(v)

        return GraphBatch(
            node_features=fn(self.node_features),
            edge_features=opt(self.edge_features),
            senders=fn(self.senders),
            receivers=fn(self.receivers),
            node_graph=fn(self.node_graph),
            node_mask=fn(self.node_mask),
            edge_mask=fn(self.edge_mask),
            graph_mask=fn(self.graph_mask),
            targets=tuple(fn(t) for t in self.targets),
            row_ptr=opt(self.row_ptr),
            graph_ptr=opt(self.graph_ptr),
            num_graphs_pad=int(self.num_graphs_pad),
        )

    @classmethod
    def from_numpy(cls, batch: "GraphBatch", device) -> "GraphBatch":
        """Tensors on ``device`` from a collated host batch of numpy arrays
        (dtypes kept: float32, int32 and bool)."""
        dev = torch.device(device)
        return batch._map(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        )

    def to(self, device) -> "GraphBatch":
        """The same tensor batch on ``device``."""
        dev = torch.device(device)
        return self._map(lambda t: t.to(dev))
