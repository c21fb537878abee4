"""Host-side collator: list[GraphSample] → padded ``GraphBatch`` of numpy arrays.

Static-shape padding into ``(N_pad, E_pad, G_pad)`` buckets, and per-head
targets unpacked from the packed ``y``/``y_loc`` layout into dense arrays.
The arrays are element for element those of the reference collator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .batch import GraphBatch
from .csr import build_graph_ptr, build_row_ptr, validate_csr
from .sample import GraphSample

LADDER_STEP_MODES = ("pow2", "mult64")


def round_up_step(
    n: int, minimum: int = 8, mode: str = "pow2", step: int = 64
) -> int:
    """Round a size up to a shape boundary. ``mode="pow2"``: next power of
    two. ``mode="mult64"``: next power of two up to ``4*step``, then the next
    multiple of ``step`` (a 520-node batch pads to 576, not 1024)."""
    if mode not in LADDER_STEP_MODES:
        raise ValueError(
            f"unknown ladder-step mode {mode!r} (expected one of "
            f"{LADDER_STEP_MODES})"
        )
    v = max(int(n), int(minimum))
    p = 1 << (v - 1).bit_length()
    if mode == "pow2" or p <= 4 * step:
        return p
    return -(-v // step) * step


def round_up_pow2(n: int, minimum: int = 8, mode: str = "pow2") -> int:
    """Round up to the next shape boundary (≥ minimum): powers of two, or the
    ``mult64`` ladder of :func:`round_up_step`."""
    if mode == "pow2":
        v = max(int(n), minimum)
        return 1 << (v - 1).bit_length()
    return round_up_step(n, minimum=minimum, mode=mode)


def unpack_targets(
    sample: GraphSample, head_types: Sequence[str], head_dims: Sequence[int]
) -> List[np.ndarray]:
    """Split a packed ``y`` (offsets in ``y_loc``) into per-head dense arrays:
    graph head → [dim]; node head → [n, dim]."""
    out = []
    y = np.asarray(sample.y).reshape(-1)
    y_loc = np.asarray(sample.y_loc).reshape(-1)
    n = sample.num_nodes
    for ihead, (htype, hdim) in enumerate(zip(head_types, head_dims)):
        sl = y[int(y_loc[ihead]) : int(y_loc[ihead + 1])]
        if htype == "graph":
            out.append(sl.reshape(hdim))
        elif htype == "node":
            out.append(sl.reshape(n, hdim))
        else:
            raise ValueError(f"Unknown head type {htype}")
    return out


def collate_graphs(
    graphs: Sequence[GraphSample],
    head_types: Sequence[str] = (),
    head_dims: Sequence[int] = (),
    num_nodes_pad: Optional[int] = None,
    num_edges_pad: Optional[int] = None,
    num_graphs_pad: Optional[int] = None,
    edge_dim: Optional[int] = None,
) -> GraphBatch:
    """Pack graphs into one padded host batch (numpy arrays); one-off
    convenience over :class:`GraphArena`."""
    return GraphArena(graphs).collate(
        np.arange(len(graphs)),
        head_types=head_types,
        head_dims=head_dims,
        num_nodes_pad=num_nodes_pad,
        num_edges_pad=num_edges_pad,
        num_graphs_pad=num_graphs_pad,
        edge_dim=edge_dim,
    )


class GraphArena:
    """Dataset-level contiguous buffers: a batch is a handful of numpy
    gathers instead of a Python loop over samples.

    Edge features: presence and width are resolved once, from the first
    edge-bearing sample that carries ``edge_attr``; samples without one
    contribute zero rows. Each graph's edges are sorted by receiver once, so
    every collated batch's receivers are non-decreasing (the CSR contract)."""

    def __init__(self, graphs: Sequence[GraphSample]):
        g = len(graphs)
        self.ns = np.fromiter((s.num_nodes for s in graphs), np.int64, g)
        self.es = np.fromiter((s.num_edges for s in graphs), np.int64, g)
        self.node_start = np.zeros(g + 1, np.int64)
        np.cumsum(self.ns, out=self.node_start[1:])
        self.edge_start = np.zeros(g + 1, np.int64)
        np.cumsum(self.es, out=self.edge_start[1:])

        self.x_all = np.concatenate(
            [np.asarray(s.x, dtype=np.float32) for s in graphs]
        )
        with_edges = [s for s in graphs if s.num_edges]
        if with_edges:
            self.ei_all = np.concatenate(
                [np.asarray(s.edge_index, dtype=np.int32) for s in with_edges],
                axis=1,
            )
            first_attr = next(
                (s.edge_attr for s in with_edges if s.edge_attr is not None), None
            )
            if first_attr is not None:
                width = np.asarray(first_attr).shape[1]
                self.ea_all = np.concatenate(
                    [
                        np.asarray(s.edge_attr, dtype=np.float32)[:, :width]
                        if s.edge_attr is not None
                        else np.zeros((s.num_edges, width), np.float32)
                        for s in with_edges
                    ]
                )
            else:
                self.ea_all = None
        else:
            self.ei_all = np.zeros((2, 0), np.int32)
            self.ea_all = None

        # Stable per-graph sort by receiver: with ascending node offsets and
        # top-index padding edges, every batch's receivers are non-decreasing.
        if self.ei_all.shape[1]:
            graph_of_edge = np.repeat(np.arange(g, dtype=np.int64), self.es)
            order = np.lexsort((self.ei_all[1], graph_of_edge))
            self.ei_all = self.ei_all[:, order]
            if self.ea_all is not None:
                self.ea_all = self.ea_all[order]
        self._csr_validated = False

        # Unlabeled samples (inference requests) carry no target arenas;
        # asking collate() for head targets then raises.
        if any(s.y is None or s.y_loc is None for s in graphs):
            self.y_all = None
            self.y_start = None
            self.y_loc = None
        else:
            ys = [np.asarray(s.y, dtype=np.float32).reshape(-1) for s in graphs]
            self.y_start = np.zeros(g + 1, np.int64)
            np.cumsum(
                np.fromiter((y.size for y in ys), np.int64, g),
                out=self.y_start[1:],
            )
            self.y_all = np.concatenate(ys) if ys else np.zeros(0, np.float32)
            self.y_loc = np.stack(
                [np.asarray(s.y_loc, dtype=np.int64).reshape(-1) for s in graphs]
            )

    @staticmethod
    def _ragged_rows(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Flat arena row indices for per-sample ranges [start, start+len)."""
        total = int(lens.sum())
        intra = np.arange(total, dtype=np.int64)
        intra -= np.repeat(np.cumsum(lens) - lens, lens)
        return np.repeat(starts, lens) + intra

    def collate(
        self,
        idx,
        head_types: Sequence[str] = (),
        head_dims: Sequence[int] = (),
        num_nodes_pad: Optional[int] = None,
        num_edges_pad: Optional[int] = None,
        num_graphs_pad: Optional[int] = None,
        edge_dim: Optional[int] = None,
    ) -> GraphBatch:
        """Pack the samples at ``idx`` into one padded host batch."""
        idx = np.asarray(idx, dtype=np.int64)
        g = len(idx)
        ns, es = self.ns[idx], self.es[idx]
        tot_nodes = int(ns.sum())
        tot_edges = int(es.sum())

        n_pad = num_nodes_pad if num_nodes_pad is not None else round_up_pow2(tot_nodes + 1)
        e_pad = num_edges_pad if num_edges_pad is not None else round_up_pow2(tot_edges + 1)
        g_pad = num_graphs_pad if num_graphs_pad is not None else g + 1
        if n_pad <= tot_nodes:
            raise ValueError(f"num_nodes_pad={n_pad} must exceed total nodes {tot_nodes}")
        if e_pad < tot_edges:
            raise ValueError(f"num_edges_pad={e_pad} must fit total edges {tot_edges}")
        if g_pad <= g:
            raise ValueError(f"num_graphs_pad={g_pad} must exceed num graphs {g}")

        feat_dim = self.x_all.shape[1]
        node_features = np.zeros((n_pad, feat_dim), dtype=np.float32)
        senders = np.full((e_pad,), n_pad - 1, dtype=np.int32)
        receivers = np.full((e_pad,), n_pad - 1, dtype=np.int32)
        node_graph = np.full((n_pad,), g_pad - 1, dtype=np.int32)
        node_mask = np.zeros((n_pad,), dtype=bool)
        edge_mask = np.zeros((e_pad,), dtype=bool)
        graph_mask = np.zeros((g_pad,), dtype=bool)
        graph_mask[:g] = True

        node_rows = self._ragged_rows(self.node_start[idx], ns)
        node_features[:tot_nodes] = self.x_all[node_rows]
        node_graph[:tot_nodes] = np.repeat(np.arange(g, dtype=np.int32), ns)
        node_mask[:tot_nodes] = True

        if edge_dim is None:
            has_edge_attr = self.ea_all is not None
            edge_dim_eff = self.ea_all.shape[1] if has_edge_attr else 0
        else:
            has_edge_attr = edge_dim > 0
            edge_dim_eff = edge_dim
        edge_features = (
            np.zeros((e_pad, edge_dim_eff), dtype=np.float32)
            if has_edge_attr
            else None
        )
        if tot_edges:
            edge_rows = self._ragged_rows(self.edge_start[idx], es)
            new_node_off = np.zeros(g, np.int64)
            np.cumsum(ns[:-1], out=new_node_off[1:])
            shift = np.repeat(new_node_off, es)
            senders[:tot_edges] = self.ei_all[0, edge_rows] + shift
            receivers[:tot_edges] = self.ei_all[1, edge_rows] + shift
            edge_mask[:tot_edges] = True
            if edge_features is not None and self.ea_all is not None:
                edge_features[:tot_edges] = self.ea_all[edge_rows, :edge_dim_eff]

        targets = [
            np.zeros(
                (g_pad, hdim) if htype == "graph" else (n_pad, hdim),
                dtype=np.float32,
            )
            for htype, hdim in zip(head_types, head_dims)
        ]
        if head_types and self.y_all is None:
            raise ValueError(
                "targets requested but the dataset has unlabeled samples "
                "(y/y_loc is None)"
            )
        for ih, (htype, hdim) in enumerate(zip(head_types, head_dims)):
            starts = self.y_start[idx] + self.y_loc[idx, ih]
            spans = self.y_loc[idx, ih + 1] - self.y_loc[idx, ih]
            if htype == "graph":
                if not (spans == hdim).all():
                    raise ValueError(
                        f"head {ih}: y_loc spans {np.unique(spans)} != "
                        f"declared graph dim {hdim}"
                    )
                targets[ih][:g] = self.y_all[starts[:, None] + np.arange(hdim)]
            elif htype == "node":
                if not (spans == ns * hdim).all():
                    raise ValueError(
                        f"head {ih}: y_loc spans don't match num_nodes * "
                        f"{hdim} (declared node dim)"
                    )
                rows = self._ragged_rows(starts, ns * hdim)
                targets[ih][:tot_nodes] = self.y_all[rows].reshape(tot_nodes, hdim)
            else:
                raise ValueError(f"Unknown head type {htype}")

        row_ptr = build_row_ptr(receivers, n_pad)
        graph_ptr = build_graph_ptr(node_graph, g_pad)
        if not self._csr_validated:
            # Structural checks once per arena: the pointers were just built
            # from these ids, so the deep searchsorted cross-check cannot fail.
            validate_csr(receivers, row_ptr, n_pad, what="receivers", deep=False)
            validate_csr(node_graph, graph_ptr, g_pad, what="node_graph", deep=False)
            self._csr_validated = True

        return GraphBatch(
            node_features=node_features,
            edge_features=edge_features,
            senders=senders,
            receivers=receivers,
            node_graph=node_graph,
            node_mask=node_mask,
            edge_mask=edge_mask,
            graph_mask=graph_mask,
            targets=tuple(targets),
            row_ptr=row_ptr,
            graph_ptr=graph_ptr,
            num_graphs_pad=g_pad,
        )


def compute_pad_sizes(
    graphs: Sequence[GraphSample], batch_size: int, ladder_step: str = "pow2"
) -> Tuple[int, int, int]:
    """Pad sizes so every batch of ``batch_size`` graphs from this dataset
    fits one shape: a worst-case batch is the ``batch_size`` largest graphs."""
    return compute_pad_sizes_from_counts(
        [s.num_nodes for s in graphs],
        [s.num_edges for s in graphs],
        batch_size,
        ladder_step=ladder_step,
    )


def compute_pad_sizes_from_counts(
    ns, es, batch_size: int, ladder_step: str = "pow2"
) -> Tuple[int, int, int]:
    """:func:`compute_pad_sizes` from per-sample node and edge counts."""
    nodes = sorted((int(n) for n in ns), reverse=True)[:batch_size]
    edges = sorted((int(e) for e in es), reverse=True)[:batch_size]
    n_pad = round_up_pow2(sum(nodes) + 1, mode=ladder_step)
    e_pad = round_up_pow2(max(sum(edges), 1) + 1, mode=ladder_step)
    return n_pad, e_pad, batch_size + 1
