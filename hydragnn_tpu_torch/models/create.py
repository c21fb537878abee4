"""Model factory: ``create_model`` with the reference's signature (the
options this port covers) and its family dispatch (PNA needs ``pna_deg``,
MFC ``max_neighbours``, CGCNN keeps the input width), plus ``dropout=``,
``device=`` and ``generator=``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..utils.device import resolve_device
from .base import CONV_TYPES, HydraGNN
from .convs import pna_degree_averages
from .loss import normalize_task_weights


def create_model(
    model_type: str,
    input_dim: int,
    hidden_dim: int,
    output_dim: Sequence[int],
    output_type: Sequence[str],
    output_heads: Dict[str, Any],
    task_weights: Sequence[float],
    num_conv_layers: int,
    *,
    initial_bias: Optional[float] = None,
    max_neighbours: Optional[int] = None,
    edge_dim: Optional[int] = None,
    pna_deg: Optional[Sequence[float]] = None,
    dropout: float = 0.25,
    compute_dtype: Optional[str] = None,
    remat: bool = False,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> HydraGNN:
    """A ``HydraGNN`` in eval mode on ``device``, its weights drawn from
    ``generator`` (a CPU ``torch.Generator``; seed 0 when omitted).
    ``dropout`` is GAT's attention dropout in train mode (the reference
    model's ``dropout`` field, 0.25 there too). ``remat`` and a
    ``compute_dtype`` other than float32 raise: not ported yet."""
    dev = resolve_device(device)
    if len(task_weights) != len(output_dim):
        raise ValueError(
            f"Inconsistent number of loss weights and tasks: {len(task_weights)} "
            f"VS {len(output_dim)}"
        )
    if model_type not in CONV_TYPES:
        raise ValueError("Unknown model_type: {0}".format(model_type))
    if remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP A4)")
    if compute_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r} is not ported yet (ROADMAP A4, A7)"
        )
    kwargs: Dict[str, Any] = {}
    if model_type == "PNA":
        if pna_deg is None:
            raise ValueError("PNA requires degree input (pna_deg).")
        avg_log, avg_lin = pna_degree_averages(pna_deg)
        kwargs.update(pna_deg_avg_log=avg_log, pna_deg_avg_lin=avg_lin)
    elif model_type == "MFC":
        if max_neighbours is None:
            raise ValueError("MFC requires max_neighbours input.")
        kwargs.update(mfc_max_degree=int(max_neighbours))
    elif model_type == "CGCNN":
        hidden_dim = input_dim  # CGCNN keeps the input's channels
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = HydraGNN(
        conv_type=model_type,
        input_dim=input_dim,
        hidden_dim=hidden_dim,
        output_dim=tuple(output_dim),
        output_type=tuple(output_type),
        config_heads=output_heads,
        num_conv_layers=num_conv_layers,
        generator=generator,
        task_weights=normalize_task_weights(task_weights),
        initial_bias=initial_bias,
        edge_dim=edge_dim,
        dropout=dropout,
        **kwargs,
    )
    return model.to(dev).eval()
