"""Segment ops: plain masked PyTorch (``segment``) and the CSR kernel path
(``csr_segment``)."""
