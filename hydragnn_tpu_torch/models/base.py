"""HydraGNN multi-headed GNN for ``conv_type="PNA"``.

  encoder:  num_conv_layers × [conv → MaskedBatchNorm → ReLU]
  readout:  masked mean over each graph's nodes (``graph_ptr`` runs, or
            the unsorted-id kernel when the batch carries no pointers)
  heads:    graph heads = shared MLP (``graph_shared``) + per-head MLP;
            node heads = one MLP shared across nodes (``type: "mlp"``).

Submodules carry the reference's flax names (``conv_{i}``, ``bn_{i}``,
``graph_shared``, ``head_{i}``), so ``utils/flax_weights.py`` maps a
reference variable tree onto this module one name to one name.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..graphs.batch import GraphBatch
from ..ops import csr_segment
from .convs import PNAConv
from .layers import MLP, MaskedBatchNorm

CONV_TYPES = ("PNA", "MFC", "GIN", "GAT", "CGCNN", "SAGE")
PORTED_CONV_TYPES = ("PNA",)


class MLPNode(nn.Module):
    """Node-level head of type ``"mlp"``: one MLP shared by all nodes, held
    as ``mlp`` as in the reference."""

    def __init__(self, in_dim: int, hidden_dims: Tuple[int, ...], out_dim: int, *, generator):
        super().__init__()
        self.mlp = MLP(in_dim, tuple(hidden_dims) + (out_dim,), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class HydraGNN(nn.Module):
    """Built by ``models/create.py:create_model``; parameters are created on
    the CPU from ``generator`` and moved to the model's device there."""

    def __init__(
        self,
        conv_type: str,
        input_dim: int,
        hidden_dim: int,
        output_dim: Tuple[int, ...],
        output_type: Tuple[str, ...],
        config_heads: Dict[str, Any],
        num_conv_layers: int,
        *,
        generator: torch.Generator,
        task_weights: Tuple[float, ...] = (),
        initial_bias: Optional[float] = None,
        edge_dim: Optional[int] = None,
        pna_deg_avg_log: float = 1.0,
        pna_deg_avg_lin: float = 1.0,
    ):
        super().__init__()
        if conv_type not in CONV_TYPES:
            raise ValueError(f"Unknown conv_type {conv_type}")
        if conv_type not in PORTED_CONV_TYPES:
            raise NotImplementedError(
                f"conv_type {conv_type!r} is not ported yet (ROADMAP A4); "
                f"ported: {PORTED_CONV_TYPES}"
            )
        self.conv_type = conv_type
        self.input_dim = int(input_dim)
        self.hidden_dim = int(hidden_dim)
        self.output_dim = tuple(output_dim)
        self.output_type = tuple(output_type)
        self.num_conv_layers = int(num_conv_layers)
        self.task_weights = tuple(task_weights)
        self.edge_dim = edge_dim

        dims = [self.input_dim] + [self.hidden_dim] * self.num_conv_layers
        for i in range(self.num_conv_layers):
            self.add_module(
                f"conv_{i}",
                PNAConv(
                    dims[i], dims[i + 1], pna_deg_avg_log, pna_deg_avg_lin,
                    generator=generator, edge_dim=edge_dim,
                ),
            )
            self.add_module(f"bn_{i}", MaskedBatchNorm(dims[i + 1]))

        node_type = None
        if "node" in self.output_type:
            node_type = config_heads.get("node", {}).get("type")
            if node_type in ("mlp_per_node", "conv"):
                raise NotImplementedError(
                    f"node head type {node_type!r} is not ported yet "
                    "(ROADMAP A4); ported: 'mlp'"
                )
            if node_type != "mlp":
                raise ValueError(
                    f"Unknown node head type {node_type}; use 'mlp', "
                    "'mlp_per_node' or 'conv'"
                )

        if "graph" in self.output_type and "graph" in config_heads:
            gcfg = config_heads["graph"]
            layout = gcfg.get("shared_layout", "framework")
            if layout not in ("framework", "reference"):
                raise ValueError(
                    f"output_heads.graph.shared_layout must be 'framework' "
                    f"or 'reference', got {layout!r}"
                )
            self.graph_shared = MLP(
                self.hidden_dim,
                [gcfg["dim_sharedlayers"]] * gcfg["num_sharedlayers"],
                generator=generator,
                activate_final=True,
                inner_activation=layout != "reference",
            )

        for ihead, (htype, hdim) in enumerate(zip(self.output_type, self.output_dim)):
            if htype == "graph":
                gcfg = config_heads["graph"]
                head = MLP(
                    gcfg["dim_sharedlayers"],
                    tuple(gcfg["dim_headlayers"][: gcfg["num_headlayers"]]) + (hdim,),
                    generator=generator,
                    final_bias_value=initial_bias,
                )
            elif htype == "node":
                ncfg = config_heads["node"]
                head = MLPNode(
                    self.hidden_dim,
                    tuple(ncfg["dim_headlayers"][: ncfg["num_headlayers"]]),
                    hdim,
                    generator=generator,
                )
            else:
                raise ValueError(f"Unknown head type {htype}")
            self.add_module(f"head_{ihead}", head)

    @property
    def use_edge_attr(self) -> bool:
        return self.edge_dim is not None and self.edge_dim > 0

    def forward(self, batch: GraphBatch) -> List[torch.Tensor]:
        """Per-head outputs: graph heads ``[G_pad, dim]``, node heads
        ``[N_pad, dim]``; rows outside the masks are padding. In train mode
        the batch norms use the masked batch moments and update their
        running averages in place."""
        x = batch.node_features
        edge_attr = batch.edge_features if self.use_edge_attr else None
        for i in range(self.num_conv_layers):
            c = getattr(self, f"conv_{i}")(
                x, batch.senders, batch.receivers, edge_attr,
                batch.edge_mask, batch.node_mask, batch.row_ptr,
            )
            x = torch.relu(getattr(self, f"bn_{i}")(c, batch.node_mask))

        x_graph = csr_segment.fused_segment_mean(
            x, batch.node_graph, batch.num_graphs_pad, mask=batch.node_mask,
            row_ptr=batch.graph_ptr,
        )

        outputs = []
        for ihead, htype in enumerate(self.output_type):
            head = getattr(self, f"head_{ihead}")
            if htype == "graph":
                outputs.append(head(self.graph_shared(x_graph)))
            else:
                outputs.append(head(x))
        return outputs
