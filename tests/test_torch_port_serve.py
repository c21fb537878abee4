"""Port parity, serving: the PyTorch port's ``InferenceEngine``
(``hydragnn_tpu_torch.serve``) on the CPU against the JAX package's
``model.apply`` on the same graphs and weights, plus its queue, shutdown,
failure and device rules. Outputs are compared per graph at rtol=1e-4,
atol=1e-5 (f32 sums in another order)."""

import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import torch

from hydragnn_tpu.graphs import collate as jcollate

from hydragnn_tpu_torch.graphs import GraphSample, compute_pad_sizes
from hydragnn_tpu_torch.serve import (
    BackpressureError,
    EngineClosedError,
    EngineFailedError,
    InferenceEngine,
)

from test_torch_port_model import (
    CONFIGS,
    jax_model_and_variables,
    make_graphs,
    port_model,
    to_jax_samples,
)

RTOL, ATOL = 1e-4, 1e-5


def _setup(config="flagship", count=20, seed=4):
    cfg = CONFIGS[config]
    graphs = make_graphs(seed, count, cfg)
    jgraphs = to_jax_samples(graphs)
    jb = jcollate.collate_graphs(jgraphs[:4], cfg["types"], cfg["dims"], edge_dim=cfg["edge_dim"])
    jmodel, variables = jax_model_and_variables(cfg, jb)
    return cfg, graphs, jgraphs, jmodel, variables


def _unlabeled(graphs):
    return [GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index, edge_attr=s.edge_attr)
            for s in graphs]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def pytest_engine_predict_matches_jax_apply(config):
    cfg, graphs, jgraphs, jmodel, variables = _setup(config)
    # Reference: model.apply on the same graphs, collated 8 at a time into
    # one padded shape (one jit trace).
    n_pad, e_pad, g_pad = jcollate.compute_pad_sizes(jgraphs, 8)
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    want = []
    for lo in range(0, len(graphs), 8):
        chunk = jgraphs[lo : lo + 8]
        jb = jcollate.collate_graphs(
            chunk, cfg["types"], cfg["dims"], num_nodes_pad=n_pad,
            num_edges_pad=e_pad, num_graphs_pad=g_pad, edge_dim=cfg["edge_dim"],
        )
        outs = [np.asarray(o) for o in apply(variables, jb)]
        start = 0
        for g, s in enumerate(chunk):
            want.append([
                o[g] if t == "graph" else o[start : start + s.num_nodes]
                for o, t in zip(outs, cfg["types"])
            ])
            start += s.num_nodes
    # Two rungs: the small one takes part of the traffic, the top one the rest.
    top = compute_pad_sizes(graphs, 8)[:2]
    low = compute_pad_sizes(sorted(graphs, key=lambda s: s.num_nodes)[:4], 4)[:2]
    engine = InferenceEngine(
        port_model(cfg, variables), device="cpu", max_batch_graphs=8,
        max_delay_ms=20.0, bucket_ladder=[low, top],
    )
    try:
        got = engine.predict(_unlabeled(graphs)[:4])
        got += engine.predict(_unlabeled(graphs)[4:])
        assert engine.batches_run >= 3
        assert engine.ladder_fallbacks == 0
    finally:
        engine.close()
    assert len(got) == len(want) == len(graphs)
    for g, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(cfg["types"])
        for k, (x, y) in enumerate(zip(a, b)):
            assert x.shape == y.shape, (g, k)
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=f"graph {g} head {k}")


def _blocked_engine(monkeypatch, queue_limit):
    """An engine whose worker holds its first batch until ``release`` is
    set, so the queue behind it fills deterministically."""
    cfg, graphs, _, _, variables = _setup(count=queue_limit + 3)
    engine = InferenceEngine(port_model(cfg, variables), device="cpu",
                             max_batch_graphs=1, max_delay_ms=0.0, queue_limit=queue_limit)
    entered, release = threading.Event(), threading.Event()
    serve = engine._serve

    def held(entries):
        entered.set()
        assert release.wait(30)
        serve(entries)

    monkeypatch.setattr(engine, "_serve", held)
    return engine, _unlabeled(graphs), entered, release


def pytest_backpressure_raises_when_queue_full(monkeypatch):
    engine, graphs, entered, release = _blocked_engine(monkeypatch, queue_limit=3)
    try:
        first = engine.submit(graphs[0])
        assert entered.wait(30)
        queued = [engine.submit(s) for s in graphs[1:4]]
        with pytest.raises(BackpressureError) as err:
            engine.submit(graphs[4])
        assert err.value.retry_after_s > 0
        with pytest.raises(ValueError, match="queue_limit"):
            engine.predict(graphs[:4] + graphs[:1])
        release.set()
        for f in [first] + queued:
            assert len(f.result(30)) == 2
    finally:
        release.set()
        engine.close()


def pytest_close_joins_worker_and_fails_stragglers(monkeypatch):
    """close() on a full queue evicts (and fails) the oldest queued request
    to fit its shutdown marker, serves everything queued before the marker,
    and joins the worker."""
    engine, graphs, entered, release = _blocked_engine(monkeypatch, queue_limit=2)
    first = engine.submit(graphs[0])
    assert entered.wait(30)
    evicted, kept = engine.submit(graphs[1]), engine.submit(graphs[2])
    assert engine.running
    closer = threading.Thread(target=engine.close)
    closer.start()
    with pytest.raises(EngineClosedError):
        evicted.result(30)
    release.set()
    closer.join(30)
    assert not closer.is_alive()
    assert not engine.running
    assert len(first.result(30)) == 2
    assert len(kept.result(30)) == 2
    with pytest.raises(EngineClosedError):
        engine.submit(graphs[3])
    engine.close()  # idempotent


def pytest_worker_failure_fails_pending_and_poisons(monkeypatch):
    cfg, graphs, _, _, variables = _setup(count=3)
    model = port_model(cfg, variables)

    def broken(batch):
        raise RuntimeError("device fault")

    monkeypatch.setattr(model, "forward", broken)
    engine = InferenceEngine(model, device="cpu", max_batch_graphs=4)
    try:
        fut = engine.submit(_unlabeled(graphs)[0])
        with pytest.raises(EngineFailedError) as err:
            fut.result(30)
        assert "device fault" in str(err.value.__cause__)
        engine._worker.join(30)
        with pytest.raises(EngineFailedError):
            engine.submit(_unlabeled(graphs)[1])
    finally:
        engine.close()


@pytest.mark.parametrize("bad", ["width", "edge_index", "edge_attr", "no_x"])
def pytest_submit_validates_requests(bad):
    cfg, graphs, _, _, variables = _setup(count=2)
    s = _unlabeled(graphs)[0]
    if bad == "width":
        s.x = np.zeros((s.num_nodes, 3), np.float32)
    elif bad == "edge_index":
        s.edge_index = s.edge_index.copy()
        s.edge_index[0, 0] = s.num_nodes
    elif bad == "edge_attr":
        s.edge_attr = None
    else:
        s.x = None
    engine = InferenceEngine(port_model(cfg, variables), device="cpu")
    try:
        with pytest.raises(ValueError):
            engine.submit(s)
    finally:
        engine.close()


def pytest_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg, _, _, _, variables = _setup(count=2)
    model = port_model(cfg, variables)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model)
    # Nothing moved: the model is still on the CPU.
    assert all(p.device.type == "cpu" for p in model.parameters())
