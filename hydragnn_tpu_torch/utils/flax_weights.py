"""Loads a reference model's flax variables into the port's ``HydraGNN``.

The input is the reference's ``{"params": ..., "batch_stats": ...}`` tree as
nested dicts of numpy arrays (what ``jax.device_get`` returns). The port's
submodules carry the flax names, so each leaf maps to one tensor:

* ``params/.../<Dense>/kernel [in, out]`` → ``<Dense>.weight [out, in]``;
* ``params/.../<Dense>/bias`` → ``<Dense>.bias``;
* ``params/bn_{i}/scale`` and ``bias`` → ``bn_{i}.weight`` and ``.bias``;
* the raw parameters of the conv families, as they are (no transpose):
  GIN's scalar ``eps``, MFC's ``w_self`` / ``w_nbr`` ``[d, F, F']`` and
  ``bias`` ``[d, F']``, GAT's ``att`` ``[heads, F']`` and ``bias``;
* ``batch_stats/bn_{i}/mean`` and ``var`` → ``bn_{i}.running_mean`` and
  ``.running_var``.

Every tensor of the model must be matched exactly once: a missing key, an
extra key or a shape mismatch raises ``KeyError``/``ValueError`` before any
tensor is written.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {
    "kernel": "weight", "bias": "bias", "scale": "weight",
    "eps": "eps", "w_self": "w_self", "w_nbr": "w_nbr", "att": "att",
}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The torch ``state_dict`` entries named by a flax variable tree."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for collection, names in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES)):
        for path, value in _leaves(variables.get(collection, {})):
            leaf = path[-1]
            if leaf not in names:
                raise KeyError(f"unexpected flax leaf {collection}/{'/'.join(path)}")
            arr = np.array(value, dtype=np.float32)  # a copy the tensor owns
            if leaf == "kernel":
                arr = arr.T
            key = ".".join(path[:-1] + (names[leaf],))
            if key in out:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} maps onto {key} twice")
            out[key] = torch.from_numpy(np.array(arr, order="C"))  # keeps 0-d shapes
    return out


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a reference variable tree into ``model`` in place (any device)
    and return it. Raises on any unmatched, missing or misshapen key."""
    incoming = flax_to_state_dict(variables)
    target = model.state_dict()
    missing = sorted(set(target) - set(incoming))
    extra = sorted(set(incoming) - set(target))
    if missing or extra:
        raise KeyError(
            f"flax variables do not match the model: missing {missing}, "
            f"unexpected {extra}"
        )
    for key, value in incoming.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{key}: flax shape {tuple(value.shape)} != model shape "
                f"{tuple(target[key].shape)}"
            )
    model.load_state_dict(incoming, strict=True)
    return model
