"""HydraGNN multi-headed GNN for the six conv families (``PNA``, ``MFC``,
``GIN``, ``GAT``, ``CGCNN``, ``SAGE``).

  encoder:  num_conv_layers × [conv → MaskedBatchNorm → ReLU]; GAT joins
            its heads on every layer but the last (widths ``hidden *
            heads``), which averages them; CGCNN keeps the input width
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
from .convs import CGConv, GATv2Conv, GINConv, MFCConv, PNAConv, SAGEConv
from .layers import MLP, MaskedBatchNorm

CONV_TYPES = ("PNA", "MFC", "GIN", "GAT", "CGCNN", "SAGE")


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
        dropout: float = 0.25,
        pna_deg_avg_log: float = 1.0,
        pna_deg_avg_lin: float = 1.0,
        mfc_max_degree: int = 10,
        gat_heads: int = 6,
        gat_negative_slope: float = 0.05,
    ):
        super().__init__()
        if conv_type not in CONV_TYPES:
            raise ValueError(f"Unknown conv_type {conv_type}")
        self.conv_type = conv_type
        self.input_dim = int(input_dim)
        self.hidden_dim = int(hidden_dim)
        self.output_dim = tuple(output_dim)
        self.output_type = tuple(output_type)
        self.num_conv_layers = int(num_conv_layers)
        self.task_weights = tuple(task_weights)
        self.edge_dim = edge_dim
        self.dropout = float(dropout)
        self._conv_kw = dict(
            pna_deg_avg_log=pna_deg_avg_log, pna_deg_avg_lin=pna_deg_avg_lin,
            mfc_max_degree=mfc_max_degree, gat_heads=gat_heads,
            gat_negative_slope=gat_negative_slope,
        )

        if conv_type == "GAT":
            h = gat_heads
            last = max(self.num_conv_layers - 1, 1)
            layers = [(self.input_dim, self.hidden_dim, True, self.hidden_dim * h)]
            layers += [(self.hidden_dim * h, self.hidden_dim, True, self.hidden_dim * h)
                       for _ in range(1, last)]
            layers.append((self.hidden_dim * h, self.hidden_dim, False, self.hidden_dim))
        else:
            dims = [self.input_dim] + [self.enc_dim] * self.num_conv_layers
            layers = [(dims[i], dims[i + 1], True, dims[i + 1])
                      for i in range(self.num_conv_layers)]
        self.num_encoder_layers = len(layers)
        for i, (d_in, d_out, concat, bn_dim) in enumerate(layers):
            self.add_module(f"conv_{i}", self._make_conv(d_in, d_out, generator, concat))
            self.add_module(f"bn_{i}", MaskedBatchNorm(bn_dim))

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
                self.enc_dim,
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
                    self.enc_dim,
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

    @property
    def enc_dim(self) -> int:
        """Width of the encoder output: ``hidden_dim``, except for CGCNN,
        which keeps the input's channels."""
        return self.input_dim if self.conv_type == "CGCNN" else self.hidden_dim

    def _make_conv(self, in_dim: int, out_dim: int, generator, concat: bool) -> nn.Module:
        kw = self._conv_kw
        ct = self.conv_type
        if ct == "SAGE":
            return SAGEConv(in_dim, out_dim, generator=generator)
        if ct == "GIN":
            return GINConv(in_dim, out_dim, generator=generator)
        if ct == "MFC":
            return MFCConv(in_dim, out_dim, kw["mfc_max_degree"], generator=generator)
        if ct == "GAT":
            return GATv2Conv(
                in_dim, out_dim, generator=generator, heads=kw["gat_heads"],
                negative_slope=kw["gat_negative_slope"], concat=concat,
                dropout=self.dropout,
            )
        if ct == "CGCNN":
            return CGConv(in_dim, generator=generator, edge_dim=self.edge_dim or 0)
        return PNAConv(
            in_dim, out_dim, kw["pna_deg_avg_log"], kw["pna_deg_avg_lin"],
            generator=generator, edge_dim=self.edge_dim,
        )

    def forward(self, batch: GraphBatch, generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """Per-head outputs: graph heads ``[G_pad, dim]``, node heads
        ``[N_pad, dim]``; rows outside the masks are padding. In train mode
        the batch norms use the masked batch moments and update their
        running averages in place, and GAT draws its attention dropout from
        ``generator`` (a ``torch.Generator`` on the model's device)."""
        x = batch.node_features
        edge_attr = batch.edge_features if self.use_edge_attr else None
        for i in range(self.num_encoder_layers):
            c = getattr(self, f"conv_{i}")(
                x, batch.senders, batch.receivers, edge_attr,
                batch.edge_mask, batch.node_mask, batch.row_ptr, generator,
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
