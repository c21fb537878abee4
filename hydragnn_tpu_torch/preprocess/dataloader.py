"""Batch iterator over ``GraphSample``s → padded host ``GraphBatch``es (the
reference's ``hydragnn_tpu/preprocess/dataloader.py``, default path).

One bucket, one shard, fixed ``batch_size`` cuts, ``reshuffle="sample"``:
each epoch shuffles the sample indices with ``numpy.random.default_rng(seed
+ epoch)`` (``set_epoch`` is the sampler's per-epoch hook) and cuts them
into batches, so batch membership and order are those of the reference
loader for the same samples, seed and epoch. Every batch is padded to the
dataset's worst-case shape (``compute_pad_sizes_from_counts``) and
collated by the port's ``GraphArena`` into numpy arrays; the trainer copies
each one to the device once with ``GraphBatch.from_numpy``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ..graphs.batch import GraphBatch
from ..graphs.collate import GraphArena, compute_pad_sizes_from_counts
from ..graphs.sample import GraphSample


class GraphDataLoader:
    def __init__(
        self,
        dataset: Sequence[GraphSample],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_rank: int = 0,
        head_types: Optional[Sequence[str]] = None,
        head_dims: Optional[Sequence[int]] = None,
        edge_dim: Optional[int] = None,
        num_buckets: int = 1,
        reshuffle: str = "sample",
        skip_budget: int = 0,
        packing: bool = False,
        ladder_step: str = "pow2",
    ):
        """The reference's signature. Options off its default path raise
        ``NotImplementedError`` naming their ROADMAP item: ``num_shards >
        1`` (A9), ``num_buckets > 1``, ``reshuffle="batch"``, ``packing``
        (A2, A6) and ``skip_budget > 0`` (A8)."""
        if reshuffle not in ("sample", "batch"):
            raise ValueError(
                f"reshuffle must be 'sample' or 'batch', got {reshuffle!r}"
            )
        for unported, item in (
            (num_shards != 1 or shard_rank != 0, "A9 (data-parallel shards)"),
            (num_buckets != 1, "A6 (size buckets)"),
            (reshuffle != "sample", "A6 (reshuffle='batch')"),
            (packing, "A2 (graph packing)"),
            (skip_budget > 0, "A8 (sample quarantine)"),
        ):
            if unported:
                raise NotImplementedError(
                    f"GraphDataLoader: this option is not ported yet (ROADMAP {item})"
                )
        self.dataset = list(dataset)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.head_types = tuple(head_types) if head_types else None
        self.head_dims = tuple(head_dims) if head_dims else None
        self.edge_dim = edge_dim
        self.ladder_step = ladder_step
        self.epoch = 0
        self._arena = None
        ns = np.fromiter((s.num_nodes for s in self.dataset), np.int64, len(self.dataset))
        es = np.fromiter((s.num_edges for s in self.dataset), np.int64, len(self.dataset))
        self.pad_sizes = (
            compute_pad_sizes_from_counts(ns, es, self.batch_size, ladder_step=ladder_step)
            if self.dataset
            else (0, 0, 0)
        )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _batch_plan(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [
            idx[start : start + self.batch_size]
            for start in range(0, len(idx), self.batch_size)
        ]

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[GraphBatch]:
        if self._arena is None and self.dataset:
            self._arena = GraphArena(self.dataset)
        n_pad, e_pad, g_pad = self.pad_sizes
        for sample_idx in self._batch_plan():
            yield self._arena.collate(
                sample_idx,
                head_types=self.head_types or (),
                head_dims=self.head_dims or (),
                num_nodes_pad=n_pad,
                num_edges_pad=e_pad,
                num_graphs_pad=g_pad,
                edge_dim=self.edge_dim,
            )
