"""Message-passing convolutions: PNA.

Call convention: ``y = conv(x, senders, receivers, edge_attr, edge_mask,
node_mask, row_ptr)`` with ``x [N_pad, F]``, ``senders``/``receivers``
``[E_pad]`` int, ``edge_attr [E_pad, D]`` or None and ``row_ptr [N_pad + 1]``
int32 (the CSR contract, ``graphs/csr.py``) or None. The aggregation's
(sum, count) passes run through ``ops/csr_segment.py``: the CSR kernel with
``row_ptr``, the unsorted-id kernel without it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import csr_segment
from .layers import dense

AGGREGATORS = ("mean", "min", "max", "std")
SCALERS = ("identity", "amplification", "attenuation", "linear")


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation: 4 aggregators × 4 degree scalers,
    a one-layer pre-MLP on messages ``[x_i, x_j, e_ij]`` and a post-MLP on
    ``[x ‖ aggregated]``, then a final linear (PyG ``PNAConv`` with towers=1,
    pre_layers=1, post_layers=1, divide_input=False).

    ``deg_avg_log`` / ``deg_avg_lin`` are the training set's degree-histogram
    statistics (:func:`pna_degree_averages`). Submodules are named
    ``pre_nn``, ``post_nn`` and ``lin`` as in the reference."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        deg_avg_log: float,
        deg_avg_lin: float,
        *,
        generator: torch.Generator,
        edge_dim: Optional[int] = None,
    ):
        super().__init__()
        self.deg_avg_log = float(deg_avg_log)
        self.deg_avg_lin = float(deg_avg_lin)
        self.edge_dim = edge_dim
        f = in_dim
        z_dim = 2 * f + (edge_dim or 0)
        self.pre_nn = dense(z_dim, f, generator)
        self.post_nn = dense(f + len(SCALERS) * len(AGGREGATORS) * f, out_dim, generator)
        self.lin = dense(out_dim, out_dim, generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask, node_mask, row_ptr):
        n, f = x.shape
        z = [x.index_select(0, receivers), x.index_select(0, senders)]
        if self.edge_dim and edge_attr is not None:
            z.append(edge_attr)
        msg = self.pre_nn(torch.cat(z, dim=-1))  # [E, f]

        agg, deg = csr_segment.pna_aggregate(
            msg, receivers, n, AGGREGATORS, mask=edge_mask, row_ptr=row_ptr
        )  # agg: [N, A, f]

        deg = deg.clamp_min(1.0)
        log_deg = torch.log(deg + 1.0)
        scale = torch.stack(  # [N, S], in SCALERS order
            [
                torch.ones_like(deg),
                log_deg / self.deg_avg_log,
                self.deg_avg_log / log_deg,
                deg / self.deg_avg_lin,
            ],
            dim=1,
        )

        # [N, S, A, f] → flat: every aggregator under every scaler.
        combined = agg[:, None, :, :] * scale[:, :, None, None]
        combined = combined.reshape(n, len(SCALERS) * len(AGGREGATORS) * f)
        out = self.post_nn(torch.cat([x, combined], dim=-1))
        return self.lin(out)


def pna_degree_averages(deg_histogram: Sequence[float]) -> Tuple[float, float]:
    """``avg(log(d + 1))`` and ``avg(d)`` over the training in-degree
    histogram, the two normalisers of the PNA scalers."""
    hist = np.asarray(deg_histogram, dtype=np.float64)
    degrees = np.arange(len(hist))
    total = hist.sum()
    if total == 0:
        return 1.0, 1.0
    avg_log = float((hist * np.log(degrees + 1)).sum() / total)
    avg_lin = float((hist * degrees).sum() / total)
    return max(avg_log, 1e-6), max(avg_lin, 1e-6)
