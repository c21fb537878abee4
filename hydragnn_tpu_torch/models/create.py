"""Model factory: ``create_model`` with the reference's signature (the
options this port covers), plus ``device=`` and ``generator=``."""

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
    edge_dim: Optional[int] = None,
    pna_deg: Optional[Sequence[float]] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> HydraGNN:
    """A ``HydraGNN`` in eval mode on ``device``, its weights drawn from
    ``generator`` (a CPU ``torch.Generator``; seed 0 when omitted)."""
    dev = resolve_device(device)
    if len(task_weights) != len(output_dim):
        raise ValueError(
            f"Inconsistent number of loss weights and tasks: {len(task_weights)} "
            f"VS {len(output_dim)}"
        )
    if model_type not in CONV_TYPES:
        raise ValueError("Unknown model_type: {0}".format(model_type))
    if model_type != "PNA":
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP A4)"
        )
    if pna_deg is None:
        raise ValueError("PNA requires degree input (pna_deg).")
    avg_log, avg_lin = pna_degree_averages(pna_deg)
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
        pna_deg_avg_log=avg_log,
        pna_deg_avg_lin=avg_lin,
    )
    return model.to(dev).eval()
