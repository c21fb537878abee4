"""Host-side radius-graph construction through scipy's ``cKDTree``.

Graph building is ragged, data-dependent host work; it stays in the input
pipeline, off the device. Only the non-periodic route is here; the periodic
neighbour list and the native cell-list builder are later work (ROADMAP).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..graphs.sample import GraphSample


def radius_graph(
    pos: np.ndarray, radius: float, max_neighbours: int, loop: bool = False
) -> np.ndarray:
    """Edges (j → i) for every j within ``radius`` of i, nearest first,
    capped at ``max_neighbours`` per receiver (torch-cluster ``radius_graph``
    semantics). Returns ``edge_index [2, E]`` int64."""
    pos = np.asarray(pos, dtype=np.float64)
    tree = cKDTree(pos)
    senders, receivers = [], []
    for i, nbrs in enumerate(tree.query_ball_point(pos, r=radius)):
        nbrs = [j for j in nbrs if loop or j != i]
        if len(nbrs) > max_neighbours:
            d = np.linalg.norm(pos[nbrs] - pos[i], axis=1)
            nbrs = [nbrs[k] for k in np.argsort(d, kind="stable")[:max_neighbours]]
        senders.extend(nbrs)
        receivers.extend([i] * len(nbrs))
    return np.asarray([senders, receivers], dtype=np.int64).reshape(2, -1)


def compute_edges(sample: GraphSample, radius, max_neighbours, periodic=False):
    """Build a sample's edges in place (``RadiusGraph``); ``edge_attr`` is
    reset to None."""
    if periodic:
        raise NotImplementedError(
            "periodic radius graphs are not ported yet (ROADMAP A6)"
        )
    sample.edge_index = radius_graph(sample.pos, radius, max_neighbours)
    sample.edge_attr = None
    return sample


def add_edge_lengths(sample: GraphSample) -> GraphSample:
    """``torch_geometric.transforms.Distance(norm=False, cat=True)``: append
    ``|p_r - p_s|`` to ``edge_attr``."""
    ei = sample.edge_index
    d = np.linalg.norm(
        np.asarray(sample.pos)[ei[1]] - np.asarray(sample.pos)[ei[0]], axis=1
    ).reshape(-1, 1).astype(np.float32)
    if sample.edge_attr is None:
        sample.edge_attr = d
    else:
        sample.edge_attr = np.concatenate(
            [np.asarray(sample.edge_attr, dtype=np.float32), d], axis=1
        )
    return sample
