from .dataloader import GraphDataLoader
from .graph_build import add_edge_lengths, compute_edges, radius_graph

__all__ = ["GraphDataLoader", "add_edge_lengths", "compute_edges", "radius_graph"]
