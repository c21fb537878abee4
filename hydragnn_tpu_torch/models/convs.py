"""Message-passing convolutions: SAGE, GIN, MFC, GATv2, CGCNN and PNA.

Call convention: ``y = conv(x, senders, receivers, edge_attr, edge_mask,
node_mask, row_ptr, generator=None)`` with ``x [N_pad, F]``,
``senders``/``receivers`` ``[E_pad]`` int, ``edge_attr [E_pad, D]`` or None,
``row_ptr [N_pad + 1]`` int32 (the CSR contract, ``graphs/csr.py``) or None,
and ``generator`` a ``torch.Generator`` on the model's device for GAT's
attention dropout in train mode. Every aggregation runs through
``ops/csr_segment.py``: with ``row_ptr`` the CSR kernel K1 (PNA's stats
bundle, min and max included: the CSR stats kernel K5); without it the
unsorted-id kernel K2/K3, or K4 under ``HYDRAGNN_PALLAS_SKIP=1``. Each class is the counterpart of the one of
the same name in ``hydragnn_tpu/models/convs.py``, with the flax
submodule and parameter names, so ``utils/flax_weights.py`` maps the
reference's variables one to one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import csr_segment
from ..ops import segment as seg
from .layers import dense, lecun_normal

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

    def forward(self, x, senders, receivers, edge_attr, edge_mask, node_mask, row_ptr,
                generator=None):
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


class SAGEConv(nn.Module):
    """GraphSAGE with mean aggregation: ``lin_self(x_i) + lin_nbr(mean_j
    x_j)``."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.lin_nbr = dense(in_dim, out_dim, generator)
        self.lin_self = dense(in_dim, out_dim, generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask, node_mask, row_ptr,
                generator=None):
        nbr = csr_segment.fused_segment_mean(
            x.index_select(0, senders), receivers, x.shape[0], mask=edge_mask, row_ptr=row_ptr
        )
        return self.lin_nbr(nbr) + self.lin_self(x)


class GINConv(nn.Module):
    """GIN: ``mlp_1(relu(mlp_0((1 + eps) x_i + sum_j x_j)))`` with a
    trainable scalar ``eps`` (initial value 100, as the reference)."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator,
                 eps_init: float = 100.0):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor(float(eps_init)))
        self.mlp_0 = dense(in_dim, out_dim, generator)
        self.mlp_1 = dense(out_dim, out_dim, generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask, node_mask, row_ptr,
                generator=None):
        agg = csr_segment.fused_segment_sum(
            x.index_select(0, senders), receivers, x.shape[0], mask=edge_mask, row_ptr=row_ptr
        )
        h = (1.0 + self.eps) * x + agg
        return self.mlp_1(torch.relu(self.mlp_0(h)))


class MFCConv(nn.Module):
    """Molecular-fingerprint conv: ``W_self[d]·x_i + W_nbr[d]·sum_j x_j +
    b[d]`` with ``d`` the node's in-degree clamped to ``max_degree``. The
    per-node weight gather is ``[N, F, F']`` per weight (134 MB at hidden
    64 and N = 8192)."""

    def __init__(self, in_dim: int, out_dim: int, max_degree: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.max_degree = int(max_degree)
        d = self.max_degree + 1
        self.w_self = lecun_normal((d, in_dim, out_dim), generator)
        self.w_nbr = lecun_normal((d, in_dim, out_dim), generator)
        self.bias = nn.Parameter(torch.zeros(d, out_dim))

    def forward(self, x, senders, receivers, edge_attr, edge_mask, node_mask, row_ptr,
                generator=None):
        agg, deg_f = csr_segment.fused_segment_sum_count(
            x.index_select(0, senders), receivers, x.shape[0], mask=edge_mask, row_ptr=row_ptr
        )
        deg = deg_f.to(torch.int64).clamp(0, self.max_degree)
        out = torch.einsum("nf,nfo->no", x, self.w_self[deg]) + torch.einsum(
            "nf,nfo->no", agg, self.w_nbr[deg]
        )
        return out + self.bias[deg]


class GATv2Conv(nn.Module):
    """GATv2 multi-head attention over the incoming edges and the node
    itself (an explicit self-attention term, not self-loop edges), leaky
    ReLU slope ``negative_slope``, attention dropout ``dropout`` in train
    mode; ``concat`` joins the heads, else they are averaged.

    The softmax over {incoming edges} ∪ {self} is shifted by the true max of
    its logits (``segment_max`` with fill -1e9, so an isolated node's shift
    is its self logit; no gradient through the shift), and the self term's
    exp joins the denominator after the edge sum. The dropout mask is drawn
    from ``generator`` in the reference's layout, ``(N + E, heads)``: rows
    ``[:N]`` for the self terms, ``[N:]`` for the edges (its bits differ
    from flax's stream)."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator,
                 heads: int = 6, negative_slope: float = 0.05, concat: bool = True,
                 dropout: float = 0.25):
        super().__init__()
        self.heads, self.out_dim = int(heads), int(out_dim)
        self.negative_slope = float(negative_slope)
        self.concat = bool(concat)
        self.dropout = float(dropout)
        self.lin_src = dense(in_dim, heads * out_dim, generator)
        self.lin_dst = dense(in_dim, heads * out_dim, generator)
        self.att = lecun_normal((heads, out_dim), generator)
        self.bias = nn.Parameter(torch.zeros(heads * out_dim if concat else out_dim))

    def forward(self, x, senders, receivers, edge_attr, edge_mask, node_mask, row_ptr,
                generator=None):
        n = x.shape[0]
        h, f = self.heads, self.out_dim
        x_src = self.lin_src(x).reshape(n, h, f)
        x_dst = self.lin_dst(x).reshape(n, h, f)
        src_e = x_src.index_select(0, senders)
        pre = F.leaky_relu(src_e + x_dst.index_select(0, receivers), self.negative_slope)
        logits = torch.einsum("ehf,hf->eh", pre, self.att)  # [E, h]
        pre_self = F.leaky_relu(x_src + x_dst, self.negative_slope)
        logit_self = torch.einsum("nhf,hf->nh", pre_self, self.att)  # [N, h]

        edge_max = seg.segment_max(logits, receivers, n, mask=edge_mask, fill=-1e9)
        m = torch.maximum(edge_max, logit_self).detach()
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        exp_e = torch.where(edge_mask[:, None], torch.exp(logits - m.index_select(0, receivers)), zero)
        exp_self = torch.where(node_mask[:, None], torch.exp(logit_self - m), zero)
        denom = csr_segment.fused_segment_sum(
            exp_e, receivers, n, mask=edge_mask, row_ptr=row_ptr
        ) + exp_self
        alpha = exp_e / denom.index_select(0, receivers).clamp_min(1e-16)  # [E, h]
        alpha_self = exp_self / denom.clamp_min(1e-16)  # [N, h]
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError(
                    "GAT attention dropout in train mode needs a torch.Generator "
                    "on the model's device (generator=)"
                )
            keep = torch.rand(
                (n + alpha.shape[0], h), generator=generator, device=alpha.device
            ) < 1.0 - self.dropout
            alpha = torch.where(keep[n:], alpha / (1.0 - self.dropout), zero)
            alpha_self = torch.where(keep[:n], alpha_self / (1.0 - self.dropout), zero)
        msgs = torch.where(edge_mask[:, None, None], src_e * alpha[..., None], zero)
        out = csr_segment.fused_segment_sum(msgs, receivers, n, row_ptr=row_ptr)  # [N, h, f]
        out = out + x_src * alpha_self[..., None]  # the self message
        out = out.reshape(n, h * f) if self.concat else out.mean(dim=1)
        return out + self.bias


class CGConv(nn.Module):
    """Crystal-graph conv, channel-preserving and add-aggregated:
    ``x_i + sum_j sigmoid(lin_f(z))·softplus(lin_s(z))`` with ``z = [x_i,
    x_j, e_ij]`` (``e_ij`` when ``edge_dim > 0``)."""

    def __init__(self, channels: int, *, generator: torch.Generator, edge_dim: int = 0):
        super().__init__()
        self.edge_dim = int(edge_dim or 0)
        z_dim = 2 * channels + self.edge_dim
        self.lin_f = dense(z_dim, channels, generator)
        self.lin_s = dense(z_dim, channels, generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask, node_mask, row_ptr,
                generator=None):
        z = [x.index_select(0, receivers), x.index_select(0, senders)]
        if self.edge_dim and edge_attr is not None:
            z.append(edge_attr)
        z = torch.cat(z, dim=-1)
        gate = torch.sigmoid(self.lin_f(z))
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        core = torch.logaddexp(self.lin_s(z), zero)  # softplus, as jax.nn.softplus
        msgs = torch.where(edge_mask[:, None], gate * core, zero)
        return x + csr_segment.fused_segment_sum(msgs, receivers, x.shape[0], row_ptr=row_ptr)


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
