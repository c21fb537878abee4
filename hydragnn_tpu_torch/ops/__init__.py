"""Segment ops: plain masked PyTorch (``segment``), the CSR kernel and the
fused ops (``csr_segment``), the unsorted-id kernel (``segment_sum_count``)."""
