"""PyTorch/CUDA port of the HydraGNN framework, written for an NVIDIA H100.

The JAX package ``hydragnn_tpu`` beside it is the reference; this package
imports nothing from it. The sub-packages carry the same names as the
reference's, so each module's counterpart is found at the same path:

* ``graphs``     — samples, CSR pointers, the padded collator, ``GraphBatch``;
* ``preprocess`` — radius-graph construction (scipy ``cKDTree``) and the
  ``GraphDataLoader``;
* ``ops``        — masked segment ops and the hand-written segment-sum
  kernels: CSR runs (``ops/csrc/csr_segment.cu``) and unsorted ids
  (``ops/csrc/segment_sum_count.cu``), with their gradients;
* ``models``     — ``HydraGNN`` with PNA convolutions, its loss and factory;
* ``train``      — the train and eval steps, ``TrainingDriver`` and
  ``train_validate_test``;
* ``serve``      — the micro-batching ``InferenceEngine``;
* ``utils``      — the device rule, the flax → torch weight loader and the
  optimizers with the plateau scheduler.

Every entry point takes ``device=`` and defaults to ``"cuda"``: without a
card that default raises instead of running on the CPU. Pass
``device="cpu"`` explicitly to run the plain PyTorch versions of the kernels.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
