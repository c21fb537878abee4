"""Port parity, host side: the PyTorch port's sample, CSR, collation and
radius-graph code (``hydragnn_tpu_torch.graphs`` / ``.preprocess``) against
the JAX package's, on the same numpy inputs. Host arrays must be identical
element for element."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hydragnn_tpu.graphs import collate as jcollate
from hydragnn_tpu.graphs import csr as jcsr
from hydragnn_tpu.graphs.sample import GraphSample as JSample
from hydragnn_tpu.preprocess import graph_build as jbuild

from hydragnn_tpu_torch.graphs import collate as tcollate
from hydragnn_tpu_torch.graphs import csr as tcsr
from hydragnn_tpu_torch.graphs.sample import GraphSample as TSample
from hydragnn_tpu_torch.preprocess import graph_build as tbuild

FIELDS = (
    "node_features", "edge_features", "senders", "receivers", "node_graph",
    "node_mask", "edge_mask", "graph_mask", "row_ptr", "graph_ptr",
)


def _raw_graphs(seed, count, n_lo=12, n_hi=26, fdim=1):
    """Flagship-style raw graphs (positions in a cube of side n^(1/3)) as
    ``(x, pos)`` numpy pairs, so both packages get the same arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(n_lo, n_hi))
        pos = rng.random((n, 3)).astype(np.float32) * (n ** (1 / 3))
        x = rng.normal(size=(n, fdim)).astype(np.float32)
        out.append((x, pos))
    return out


def _samples(raw, heads):
    """The same graphs as port and reference ``GraphSample``s: edges from the
    port's builder (radius 1.2, cap 20) plus lengths, packed targets for
    ``heads`` (graph heads: sum of x; node heads: x0)."""
    tg, jg = [], []
    for x, pos in raw:
        parts, loc = [], [0]
        for htype in heads:
            part = np.asarray([x.sum()]) if htype == "graph" else x[:, 0]
            parts.append(part)
            loc.append(loc[-1] + part.size)
        s = TSample(
            x=x, pos=pos, y=np.concatenate(parts).astype(np.float32),
            y_loc=np.asarray([loc], dtype=np.int64),
        )
        tbuild.compute_edges(s, radius=1.2, max_neighbours=20)
        tbuild.add_edge_lengths(s)
        tg.append(s)
        jg.append(JSample(**vars(s.clone())))
    return jg, tg


def _edge_set(ei):
    ei = np.asarray(ei)
    order = np.lexsort((ei[1], ei[0]))
    return ei[:, order]


@pytest.mark.parametrize("seed", [0, 1, 2])
def pytest_compute_edges_same_edge_set(seed):
    raw = _raw_graphs(seed, 6, n_lo=4, n_hi=40)
    for x, pos in raw:
        js = jbuild.compute_edges(JSample(x=x, pos=pos), radius=1.2, max_neighbours=5)
        ts = tbuild.compute_edges(TSample(x=x, pos=pos), radius=1.2, max_neighbours=5)
        assert ts.edge_attr is None
        np.testing.assert_array_equal(_edge_set(ts.edge_index), _edge_set(js.edge_index))
        jbuild.add_edge_lengths(js)
        tbuild.add_edge_lengths(ts)
        # Lengths of the same edges, compared in (sender, receiver) order.
        oj = np.lexsort((js.edge_index[1], js.edge_index[0]))
        ot = np.lexsort((ts.edge_index[1], ts.edge_index[0]))
        np.testing.assert_array_equal(ts.edge_attr[ot], js.edge_attr[oj])


def pytest_periodic_edges_not_ported():
    s = TSample(x=np.zeros((2, 1), np.float32), pos=np.zeros((2, 3), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbuild.compute_edges(s, radius=1.0, max_neighbours=4, periodic=True)


HEAD_SETS = {
    "flagship": (("graph", "node"), (1, 1)),
    "multihead": (("graph", "node", "node", "node"), (1, 1, 1, 1)),
}


@pytest.mark.parametrize("heads", sorted(HEAD_SETS))
@pytest.mark.parametrize("pads", ["ladder", "roundup"])
def pytest_collate_arrays_identical(heads, pads):
    types, dims = HEAD_SETS[heads]
    raw = _raw_graphs(3, 9)
    jg, tg = _samples(raw, types)
    kw = {}
    if pads == "ladder":
        n_pad, e_pad, g_pad = tcollate.compute_pad_sizes(tg, 16)
        assert (n_pad, e_pad, g_pad) == jcollate.compute_pad_sizes(jg, 16)
        kw = dict(num_nodes_pad=n_pad, num_edges_pad=e_pad, num_graphs_pad=g_pad)
    jb = jcollate.collate_graphs(jg, types, dims, edge_dim=1, **kw)
    tb = tcollate.collate_graphs(tg, types, dims, edge_dim=1, **kw)
    for name in FIELDS:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name)
        assert isinstance(b, np.ndarray), name
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert len(tb.targets) == len(jb.targets) == len(types)
    for a, b in zip(jb.targets, tb.targets):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert tb.num_graphs_pad == jb.num_graphs_pad
    assert (tb.num_nodes_pad, tb.num_edges_pad) == (jb.num_nodes_pad, jb.num_edges_pad)


@pytest.mark.parametrize("edge_dim", [None, 0, 2])
def pytest_arena_subset_collate_identical(edge_dim):
    """An arena batch over a subset of its samples, with edge features
    absent, dropped or zero-widened, matches the reference arena's."""
    raw = _raw_graphs(4, 7)
    jg, tg = _samples(raw, ("graph",))
    if edge_dim is None:
        for s in jg + tg:
            s.edge_attr = None
    idx = np.asarray([5, 0, 3])
    jb = jcollate.GraphArena(jg).collate(idx, ("graph",), (1,), edge_dim=edge_dim)
    tb = tcollate.GraphArena(tg).collate(idx, ("graph",), (1,), edge_dim=edge_dim)
    for name in FIELDS:
        a, b = getattr(jb, name), getattr(tb, name)
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


@pytest.mark.parametrize("mode", ["pow2", "mult64"])
def pytest_round_up_and_pad_sizes_identical(mode):
    for n in list(range(0, 300)) + [511, 512, 513, 520, 1000, 4097, 70000]:
        assert tcollate.round_up_pow2(n, mode=mode) == jcollate.round_up_pow2(n, mode=mode)
    rng = np.random.default_rng(5)
    ns = rng.integers(1, 60, 300)
    es = rng.integers(0, 400, 300)
    for bs in (1, 7, 64, 256):
        assert tcollate.compute_pad_sizes_from_counts(ns, es, bs, mode) == (
            jcollate.compute_pad_sizes_from_counts(ns, es, bs, mode)
        )
    with pytest.raises(ValueError, match="ladder-step"):
        tcollate.round_up_step(10, mode="bogus")


def pytest_unpack_targets_identical():
    types, dims = ("graph", "node", "node"), (2, 1, 3)
    rng = np.random.default_rng(6)
    n = 5
    y = rng.normal(size=2 + n + 3 * n).astype(np.float32)
    y_loc = np.asarray([[0, 2, 2 + n, 2 + 4 * n]])
    ja = jcollate.unpack_targets(JSample(x=np.zeros((n, 1)), y=y, y_loc=y_loc), types, dims)
    ta = tcollate.unpack_targets(TSample(x=np.zeros((n, 1)), y=y, y_loc=y_loc), types, dims)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b, a)


def pytest_collate_rejects_like_reference():
    raw = _raw_graphs(7, 3)
    _, tg = _samples(raw, ("graph",))
    total = sum(s.num_nodes for s in tg)
    with pytest.raises(ValueError, match="num_nodes_pad"):
        tcollate.collate_graphs(tg, ("graph",), (1,), num_nodes_pad=total)
    with pytest.raises(ValueError, match="num_graphs_pad"):
        tcollate.collate_graphs(tg, ("graph",), (1,), num_graphs_pad=3)
    with pytest.raises(ValueError, match="declared graph dim"):
        tcollate.collate_graphs(tg, ("graph",), (2,))
    unlabeled = [TSample(x=s.x, pos=s.pos, edge_index=s.edge_index) for s in tg]
    with pytest.raises(ValueError, match="unlabeled"):
        tcollate.collate_graphs(unlabeled, ("graph",), (1,))


@pytest.mark.parametrize(
    "case", ["ok", "short", "endpoint", "unsorted", "range", "deep"]
)
def pytest_validate_csr_agrees_with_reference(case):
    ids = np.asarray([0, 0, 1, 3, 3, 3], np.int32)
    n = 4
    row_ptr = tcsr.build_row_ptr(ids, n)
    np.testing.assert_array_equal(row_ptr, jcsr.build_row_ptr(ids, n))
    np.testing.assert_array_equal(
        tcsr.build_graph_ptr(ids, n), jcsr.build_graph_ptr(ids, n)
    )
    if case == "short":
        row_ptr = row_ptr[:-1]
    elif case == "endpoint":
        row_ptr = row_ptr.copy()
        row_ptr[-1] = 5
    elif case == "unsorted":
        ids = ids[::-1].copy()
    elif case == "range":
        ids = ids.copy()
        ids[-1] = 7
    elif case == "deep":
        row_ptr = row_ptr.copy()
        row_ptr[2] = 2  # monotone, right endpoints, wrong boundary
    want = None
    try:
        jcsr.validate_csr(ids, row_ptr, n)
    except ValueError as e:
        want = str(e)
    if want is None:
        tcsr.validate_csr(ids, row_ptr, n)
    else:
        with pytest.raises(ValueError) as got:
            tcsr.validate_csr(ids, row_ptr, n)
        assert str(got.value) == want
    assert (case == "ok") == (want is None)


def pytest_build_row_ptr_rejects_out_of_range_ids():
    with pytest.raises(ValueError, match="num_segments"):
        tcsr.build_row_ptr(np.asarray([0, 5]), 3)


def pytest_sample_clone_is_deep():
    s = TSample(x=np.ones((2, 1), np.float32), pos=np.zeros((2, 3), np.float32))
    c = s.clone()
    c.x[0, 0] = 5.0
    assert s.x[0, 0] == 1.0 and c.num_nodes == 2 and c.num_edges == 0
