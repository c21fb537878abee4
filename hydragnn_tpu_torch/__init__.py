"""PyTorch/CUDA port of the HydraGNN framework, written for an NVIDIA H100.

The JAX package ``hydragnn_tpu`` beside it is the reference; this package
imports nothing from it. The sub-packages carry the same names as the
reference's, so each module's counterpart is found at the same path:

* ``graphs``     — samples, CSR pointers, the padded collator, ``GraphBatch``;
* ``preprocess`` — radius-graph construction (scipy ``cKDTree``);
* ``ops``        — masked segment ops and the hand-written CSR segment-sum
  kernel (``ops/csrc/csr_segment.cu``);
* ``models``     — ``HydraGNN`` with PNA convolutions, its loss and factory;
* ``serve``      — the micro-batching ``InferenceEngine``;
* ``utils``      — the device rule and the flax → torch weight loader.

Every entry point takes ``device=`` and defaults to ``"cuda"``: without a
card that default raises instead of running on the CPU. Pass
``device="cpu"`` explicitly to run the plain PyTorch versions of the kernels.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
