"""CSR batch contract: destination-sorted edges plus precomputed row pointers.

Collation sorts every graph's edges by receiver (``GraphArena``), so a
batch's receivers are globally non-decreasing. Then:

* :func:`build_row_ptr` gives ``row_ptr[N_pad + 1]`` over the padded receiver
  array: ``row_ptr[n]`` is the first edge whose receiver is ``>= n``, and
  ``row_ptr[n + 1] - row_ptr[n]`` is the in-degree of node ``n``;
* :func:`build_graph_ptr` gives the same pointers over ``node_graph`` (nodes
  are contiguous per graph), for the mean-pool readout;
* :func:`validate_csr` is the one checkable definition of the contract.

Padding edges connect padding nodes at the top index (receiver ``N_pad - 1``),
so the padding node's row absorbs them. Every segment reduction of the model
walks these runs (``ops/csr_segment.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def build_row_ptr(ids: np.ndarray, num_segments: int) -> np.ndarray:
    """``row_ptr[num_segments + 1]`` int32 for NON-DECREASING ``ids`` [E]:
    ``row_ptr[s] = searchsorted(ids, s, side="left")`` in O(E) via bincount
    and an exclusive cumsum. Only meaningful under the sorted contract."""
    ids = np.asarray(ids)
    counts = np.bincount(ids, minlength=num_segments)
    if len(counts) > num_segments:
        raise ValueError(
            f"ids reference segment {int(ids.max())} >= num_segments "
            f"{num_segments}"
        )
    row_ptr = np.zeros(num_segments + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr


def build_graph_ptr(node_graph: np.ndarray, num_graphs: int) -> np.ndarray:
    """``graph_ptr[num_graphs + 1]`` over the (sorted) node→graph ids."""
    return build_row_ptr(node_graph, num_graphs)


def validate_csr(
    ids: np.ndarray,
    row_ptr: np.ndarray,
    num_segments: int,
    what: str = "receivers",
    num_rows: Optional[int] = None,
    deep: bool = True,
) -> None:
    """Raise ``ValueError`` unless ``(ids, row_ptr)`` satisfies the contract:

    * ``row_ptr`` has ``num_segments + 1`` entries, starts at 0, ends at
      ``len(ids)`` and never decreases;
    * ``ids`` is non-decreasing and in ``[0, num_segments)``;
    * (``deep`` only) ``row_ptr[s]`` is the first position with ``ids >= s``.

    ``deep=False`` skips the searchsorted cross-check, which a ``row_ptr``
    just built from the same ids by :func:`build_row_ptr` cannot fail."""
    ids = np.asarray(ids)
    row_ptr = np.asarray(row_ptr)
    e = len(ids) if num_rows is None else int(num_rows)
    if row_ptr.shape != (num_segments + 1,):
        raise ValueError(
            f"CSR contract violated for {what}: row_ptr shape "
            f"{row_ptr.shape} != ({num_segments + 1},)"
        )
    if row_ptr[0] != 0 or row_ptr[-1] != e:
        raise ValueError(
            f"CSR contract violated for {what}: row_ptr endpoints "
            f"({int(row_ptr[0])}, {int(row_ptr[-1])}) != (0, {e})"
        )
    if (np.diff(row_ptr) < 0).any():
        raise ValueError(
            f"CSR contract violated for {what}: row_ptr is not monotone"
        )
    if len(ids):
        if (np.diff(ids) < 0).any():
            k = int(np.argmax(np.diff(ids) < 0))
            raise ValueError(
                f"CSR contract violated for {what}: ids not sorted at row "
                f"{k} ({int(ids[k])} -> {int(ids[k + 1])})"
            )
        if int(ids.min()) < 0 or int(ids.max()) >= num_segments:
            raise ValueError(
                f"CSR contract violated for {what}: ids outside "
                f"[0, {num_segments})"
            )
    if not deep:
        return
    expect = np.searchsorted(ids, np.arange(num_segments + 1)).astype(
        row_ptr.dtype
    )
    if not np.array_equal(row_ptr, expect):
        bad = int(np.argmax(row_ptr != expect))
        raise ValueError(
            f"CSR contract violated for {what}: row_ptr[{bad}] = "
            f"{int(row_ptr[bad])}, ids say {int(expect[bad])}"
        )
