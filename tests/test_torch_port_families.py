"""Port parity, the conv families SAGE, GIN, MFC, GAT (GATv2) and CGCNN: the
port's ``HydraGNN`` with the weights of the JAX package's model carried
across (``load_flax_variables``) against ``model.apply`` and ``jax.grad``
of the reference's ``_loss_and_metrics`` on the same collated batch, on the
CPU, on four routes:

* ``xla``: the JAX side on its XLA segment ops, the port with CSR pointers;
* ``csr_kernel``: ``HYDRAGNN_PALLAS=1``, the CSR kernel on both sides;
* ``no_pointers``: ``HYDRAGNN_PALLAS=1`` on a batch without ``row_ptr`` /
  ``graph_ptr`` (the JAX one-hot kernels, the port's K2/K3);
* ``no_pointers_skip``: the same with ``HYDRAGNN_PALLAS_SKIP=1`` on both
  sides (the JAX ``_skip_kernel``, the port's K4).

Small sizes: 5 graphs of 6-16 nodes, hidden 8, 2 conv layers, the flagship's
heads (a graph head and an ``mlp`` node head, edge lengths). GAT runs with
its attention dropout at 0 on both sides for every comparison (flax:
``model.clone(dropout=0.0)``): the two random streams cannot match.
Tolerance rtol=1e-4, atol=1e-5 (f32 sums in another order)."""

import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import torch

from hydragnn_tpu.graphs import collate as jcollate
from hydragnn_tpu.graphs.sample import GraphSample as JSample
from hydragnn_tpu.models import create_model as jcreate
from hydragnn_tpu.models import init_model_variables
from hydragnn_tpu.models import multihead_rmse_loss as jloss
from hydragnn_tpu.train.trainer import _loss_and_metrics

from hydragnn_tpu_torch.graphs import GraphBatch, GraphSample, collate_graphs
from hydragnn_tpu_torch.models import create_model, multihead_rmse_loss
from hydragnn_tpu_torch.ops import segment_sum_count as ssc
from hydragnn_tpu_torch.preprocess import GraphDataLoader
from hydragnn_tpu_torch.train import TrainingDriver, loss_and_grads, train_validate_test
from hydragnn_tpu_torch.utils import load_flax_variables, select_optimizer
from hydragnn_tpu_torch.utils.flax_weights import flax_to_state_dict

from test_torch_port_model import CONFIGS, assert_outputs_close, make_graphs, to_jax_samples

RTOL, ATOL = 1e-4, 1e-5
FAMILIES = ("SAGE", "GIN", "MFC", "GAT", "CGCNN")
ROUTES = ("xla", "csr_kernel", "no_pointers", "no_pointers_skip")
HIDDEN, LAYERS, MAX_NEIGHBOURS = 8, 2, 4
CFG = CONFIGS["flagship"]


def _route(monkeypatch, route):
    monkeypatch.delenv("HYDRAGNN_SEGMENT_SORTED", raising=False)
    monkeypatch.delenv("HYDRAGNN_PALLAS_CSR", raising=False)
    if route == "xla":
        monkeypatch.delenv("HYDRAGNN_PALLAS", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_PALLAS", "1")
    if route == "no_pointers_skip":
        monkeypatch.setenv("HYDRAGNN_PALLAS_SKIP", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_PALLAS_SKIP", raising=False)


def _family_kw(family, max_neighbours=MAX_NEIGHBOURS):
    return dict(edge_dim=CFG["edge_dim"], max_neighbours=max_neighbours,
                pna_deg=[0, 0, 1, 2, 4, 8, 8, 4, 2, 1])


def _perturb(tree, rng):
    """Batch-norm statistics and every bias off their initial values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "var" or k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _models(family, graphs, host, input_dim=1, hidden=HIDDEN, max_neighbours=MAX_NEIGHBOURS,
            cfg=CFG):
    """(flax model with dropout 0, its numpy variables, the port's model on
    the CPU carrying them)."""
    jb = jcollate.collate_graphs(to_jax_samples(graphs), cfg["types"], cfg["dims"],
                                 edge_dim=cfg["edge_dim"])
    kw = _family_kw(family, max_neighbours)
    jmodel = jcreate(family, input_dim, hidden, cfg["dims"], cfg["types"], cfg["heads"],
                     cfg["weights"], LAYERS, **kw).clone(dropout=0.0)
    variables = jax.device_get(init_model_variables(jmodel, jb))
    rng = np.random.default_rng(100)
    variables = {c: _perturb(dict(t), rng) for c, t in variables.items()}
    model = create_model(family, input_dim, hidden, cfg["dims"], cfg["types"], cfg["heads"],
                         cfg["weights"], LAYERS, dropout=0.0, device="cpu", **kw)
    return jmodel, variables, load_flax_variables(model, variables), jb


@functools.lru_cache(maxsize=None)
def _graphs(seed=1, count=5):
    graphs = make_graphs(seed, count, CFG)
    return graphs, collate_graphs(graphs, CFG["types"], CFG["dims"], edge_dim=CFG["edge_dim"])


def _batches(route, host, jb):
    batch = GraphBatch.from_numpy(host, "cpu")
    if route.startswith("no_pointers"):
        jb = jb.replace(row_ptr=None, graph_ptr=None)
        batch.row_ptr = batch.graph_ptr = None
    return batch, jb


def _forward_matches(family, route, graphs, host, **kw):
    jmodel, variables, model, jb = _models(family, graphs, host, **kw)
    batch, jb = _batches(route, host, jb)
    j_out = jmodel.apply(variables, jb, train=False)
    j_total, j_rmses = jloss(j_out, jb, CFG["types"], jmodel.task_weights)
    before = ssc.SKIP_LAUNCHES, ssc.KERNEL_LAUNCHES
    with torch.inference_mode():
        t_out = model(batch)
        t_total, t_rmses = multihead_rmse_loss(t_out, batch, model.output_type, model.task_weights)
    assert (ssc.SKIP_LAUNCHES, ssc.KERNEL_LAUNCHES) == before  # CPU: plain versions
    assert_outputs_close(t_out, j_out, CFG["types"], host.node_mask, host.graph_mask)
    np.testing.assert_allclose(t_rmses.numpy(), np.asarray(j_rmses), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=RTOL, atol=ATOL)
    return model, jmodel


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family", FAMILIES)
def pytest_family_forward_and_loss_match_jax(monkeypatch, family, route):
    _route(monkeypatch, route)
    graphs, host = _graphs()
    _forward_matches(family, route, graphs, host)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family", FAMILIES)
def pytest_family_train_step_matches_jax(monkeypatch, family, route):
    """Train mode: the loss, every parameter's gradient and the updated
    batch-norm statistics against ``jax.value_and_grad`` of the reference's
    ``_loss_and_metrics``."""
    _route(monkeypatch, route)
    graphs, host = _graphs()
    jmodel, variables, model, jb = _models(family, graphs, host)
    batch, jb = _batches(route, host, jb)
    (j_loss, (j_stats, j_rmses)), j_grads = jax.value_and_grad(
        lambda p: _loss_and_metrics(jmodel, p, variables["batch_stats"], jb, jax.random.PRNGKey(0)),
        has_aux=True,
    )(variables["params"])
    loss, rmses, grads = loss_and_grads(model, batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rmses.numpy(), np.asarray(j_rmses), rtol=RTOL, atol=ATOL)
    want = {k: v.numpy() for k, v in flax_to_state_dict({"params": jax.device_get(j_grads)}).items()}
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)
    stats = {k: v.numpy() for k, v in
             flax_to_state_dict({"batch_stats": jax.device_get(j_stats)}).items()}
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name], rtol=RTOL, atol=ATOL, err_msg=name)


def _with_isolated_node(seed=7):
    """Graphs of which the first has one node far from every other (no
    edges: GAT's edge max takes its -1e9 fill there)."""
    graphs = make_graphs(seed, 4, CFG)
    s = graphs[0]
    pos = s.pos.copy()
    pos[0] = 100.0
    g = GraphSample(x=s.x, pos=pos, y=s.y, y_loc=s.y_loc)
    from hydragnn_tpu_torch.preprocess import add_edge_lengths, compute_edges

    compute_edges(g, radius=1.2, max_neighbours=20)
    add_edge_lengths(g)
    assert not (g.edge_index == 0).any()
    return [g] + graphs[1:]


@pytest.mark.parametrize("route", ["csr_kernel", "no_pointers_skip"])
def pytest_gat_isolated_node_matches_jax(monkeypatch, route):
    """An isolated node's softmax runs over its self term alone (shift = its
    self logit, alpha_self = 1), on the CSR route and under the skip
    switch."""
    _route(monkeypatch, route)
    graphs = _with_isolated_node()
    host = collate_graphs(graphs, CFG["types"], CFG["dims"], edge_dim=1)
    _forward_matches("GAT", route, graphs, host)


def pytest_mfc_degree_clamp_matches_jax(monkeypatch):
    """Nodes whose in-degree exceeds ``max_neighbours`` take the weights of
    the clamped degree, as the reference's."""
    _route(monkeypatch, "no_pointers_skip")
    graphs, host = _graphs()
    deg = np.bincount(host.receivers[host.edge_mask], minlength=host.num_nodes_pad)
    assert deg.max() > 2
    _forward_matches("MFC", "no_pointers_skip", graphs, host, max_neighbours=2)


def pytest_cgcnn_keeps_the_input_channels(monkeypatch):
    """CGCNN's encoder keeps the input width whatever ``hidden_dim`` says
    (the reference's ``create_model`` sets ``hidden_dim = input_dim``), and
    its heads read that width; with 3 input channels against the JAX model."""
    _route(monkeypatch, "csr_kernel")
    cfg = dict(CONFIGS["flagship"], input_dim=3)
    graphs = make_graphs(3, 4, cfg)
    host = collate_graphs(graphs, cfg["types"], cfg["dims"], edge_dim=1)
    jmodel, variables, model, jb = _models("CGCNN", graphs, host, input_dim=3, hidden=16, cfg=cfg)
    assert model.enc_dim == 3 and model.hidden_dim == 3
    assert [getattr(model, f"bn_{i}").weight.shape[0] for i in range(LAYERS)] == [3] * LAYERS
    assert model.conv_0.lin_f.weight.shape == (3, 2 * 3 + 1)
    assert model.graph_shared.dense_0.weight.shape[1] == 3
    j_out = jmodel.apply(variables, jb, train=False)
    with torch.inference_mode():
        t_out = model(GraphBatch.from_numpy(host, "cpu"))
    assert_outputs_close(t_out, j_out, cfg["types"], host.node_mask, host.graph_mask)


@pytest.mark.parametrize("family", ("PNA",) + FAMILIES)
def pytest_create_model_builds_every_family(family):
    """``create_model`` builds each of the six families on the CPU, its
    parameters named and shaped as the reference's flax tree (the loader
    matches every leaf), at the flagship's 3 layers."""
    graphs, host = _graphs()
    jb = jcollate.collate_graphs(to_jax_samples(graphs), CFG["types"], CFG["dims"], edge_dim=1)
    kw = _family_kw(family)
    jmodel = jcreate(family, 1, HIDDEN, CFG["dims"], CFG["types"], CFG["heads"], CFG["weights"],
                     3, **kw)
    variables = jax.device_get(init_model_variables(jmodel, jb))
    model = create_model(family, 1, HIDDEN, CFG["dims"], CFG["types"], CFG["heads"],
                         CFG["weights"], 3, device="cpu", **kw)
    load_flax_variables(model, variables)
    assert model.conv_type == family


@pytest.mark.parametrize("family,missing", [("MFC", "max_neighbours"), ("PNA", "pna_deg")])
def pytest_family_inputs_are_required(family, missing):
    kw = _family_kw(family)
    del kw[missing]
    with pytest.raises(ValueError, match=missing):
        create_model(family, 1, HIDDEN, CFG["dims"], CFG["types"], CFG["heads"],
                     CFG["weights"], LAYERS, device="cpu", **kw)


def pytest_gat_dropout_uses_the_generator():
    """GAT's attention dropout (0.25 by default) in train mode: drawn from
    the given generator (the same seed gives the same loss and gradients,
    another seed others), refused without one, and off in eval mode."""
    graphs, host = _graphs()
    batch = GraphBatch.from_numpy(host, "cpu")
    model = create_model("GAT", 1, HIDDEN, CFG["dims"], CFG["types"], CFG["heads"],
                         CFG["weights"], LAYERS, device="cpu", **_family_kw("GAT"))
    assert model.conv_0.dropout == 0.25

    def step(seed):
        m = __import__("copy").deepcopy(model)
        return loss_and_grads(m, batch, torch.Generator().manual_seed(seed))

    a, b, c = step(5), step(5), step(6)
    assert float(a[0]) == float(b[0]) and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert float(a[0]) != float(c[0])
    with pytest.raises(ValueError, match="generator"):
        loss_and_grads(__import__("copy").deepcopy(model), batch)
    model.eval()
    with torch.inference_mode():
        first, second = model(batch), model(batch)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("family", FAMILIES)
def pytest_family_trains_on_the_cpu(family):
    """Three epochs through ``TrainingDriver`` / ``train_validate_test``
    with the family's defaults (GAT's dropout on, drawn from the driver's
    generator): finite history, and the train loss falls."""
    rng_graphs = make_graphs(11, 24, CFG)
    kw = dict(head_types=CFG["types"], head_dims=CFG["dims"], edge_dim=1, seed=0)
    loaders = [GraphDataLoader(rng_graphs[:16], 8, shuffle=True, **kw),
               GraphDataLoader(rng_graphs[16:20], 4, shuffle=False, **kw),
               GraphDataLoader(rng_graphs[20:], 4, shuffle=False, **kw)]
    model = create_model(family, 1, HIDDEN, CFG["dims"], CFG["types"], CFG["heads"],
                         CFG["weights"], LAYERS, device="cpu", **_family_kw(family))
    driver = TrainingDriver(model, select_optimizer(model, "adamw", 1e-2), device="cpu")
    hist = train_validate_test(driver, *loaders, 3)
    losses = hist["total_loss_train"]
    assert np.isfinite(losses).all() and np.isfinite(hist["total_loss_val"]).all()
    assert losses[-1] < losses[0]
