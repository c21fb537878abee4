"""Shared layers: padding-aware BatchNorm and plain MLP stacks.

Initialisation follows the reference's flax defaults (``Dense``: LeCun
normal kernel, zero bias; BatchNorm: unit scale, zero bias, running mean 0
and variance 1), drawn from an explicit CPU ``torch.Generator`` so that a
seed gives the same weights whatever the device. The weights of a trained
reference model come in through ``utils/flax_weights.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.segment import masked_mean

# flax's variance_scaling(1, "fan_in", "truncated_normal"): the standard
# deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def dense(
    in_dim: int,
    out_dim: int,
    generator: torch.Generator,
    bias_value: float = 0.0,
) -> nn.Linear:
    """``nn.Linear(in_dim, out_dim)`` on the CPU, initialised as flax's
    ``Dense``: truncated-normal LeCun kernel, constant bias."""
    lin = nn.Linear(in_dim, out_dim, device="meta").to_empty(device="cpu")
    std = math.sqrt(1.0 / max(in_dim, 1)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(
            lin.weight, std=std, a=-2 * std, b=2 * std, generator=generator
        )
        lin.bias.fill_(bias_value)
    return lin


def lecun_normal(shape: Sequence[int], generator: torch.Generator) -> nn.Parameter:
    """A raw parameter initialised as flax's ``lecun_normal()``: truncated
    normal, variance 1 / fan_in, where fan_in is ``shape[-2]`` times the
    product of the leading axes (flax's fan rule: in axis -2, out axis -1)."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    std = math.sqrt(1.0 / max(fan_in, 1)) / _TRUNC_STD
    t = torch.empty(tuple(shape))
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    return nn.Parameter(t)


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose statistics cover real rows only; padding rows come
    out zero. Running averages use momentum 0.9
    (``running = 0.9 * running + 0.1 * batch``) and serve eval mode."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # At least f32; an f64 input stays f64 (an f64 reference step).
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = masked_mean(x, mask, axis=0)
            var = (masked_mean(x.square(), mask, axis=0) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


class MLP(nn.Module):
    """Linear(dims[0]) → ReLU → ... → Linear(dims[-1]); submodules are named
    ``dense_{i}`` as in the reference.

    ``activate_final`` adds a trailing ReLU; ``final_bias_value`` sets the
    last bias; ``inner_activation=False`` drops the ReLUs between Linears
    (the reference's "shared" Sequential grammar)."""

    def __init__(
        self,
        in_dim: int,
        dims: Sequence[int],
        *,
        generator: torch.Generator,
        activate_final: bool = False,
        final_bias_value: Optional[float] = None,
        inner_activation: bool = True,
    ):
        super().__init__()
        self.activate_final = activate_final
        self.inner_activation = inner_activation
        self.depth = len(dims)
        prev = in_dim
        for i, d in enumerate(dims):
            last = i == len(dims) - 1
            bias = final_bias_value if (last and final_bias_value is not None) else 0.0
            self.add_module(f"dense_{i}", dense(prev, d, generator, bias))
            prev = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            last = i == self.depth - 1
            x = getattr(self, f"dense_{i}")(x)
            if (last and self.activate_final) or (not last and self.inner_activation):
                x = torch.relu(x)
        return x
