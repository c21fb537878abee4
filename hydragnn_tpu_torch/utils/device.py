"""The port's device rule: the caller names the device, the default is the card.

Nothing here moves work to the CPU on its own. ``resolve_device("cuda")`` on a
machine without a usable card raises; the CPU is reached only when a caller
passes ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present. On the first CUDA use it pins full-f32 matmuls."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        # The JAX reference computes in full f32. TF32 keeps ~10 mantissa
        # bits, so both TF32 switches stay off wherever the port touches the
        # card (cuDNN's default is on).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
