"""Port parity, model: the PyTorch port's ``HydraGNN`` (PNA) with weights
carried across from the JAX package's flax variables
(``hydragnn_tpu_torch.utils.flax_weights``) against ``model.apply`` on the
same collated batch, on the CPU. Forward outputs and the multi-head loss are
compared at real rows (``node_mask``/``graph_mask``) at rtol=1e-4,
atol=1e-5: f32 sums in another order."""

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

from hydragnn_tpu_torch.graphs import GraphBatch, GraphSample
from hydragnn_tpu_torch.graphs import collate_graphs
from hydragnn_tpu_torch.models import create_model, multihead_rmse_loss
from hydragnn_tpu_torch.preprocess import add_edge_lengths, compute_edges
from hydragnn_tpu_torch.utils import load_flax_variables

RTOL, ATOL = 1e-4, 1e-5
PNA_DEG = [0, 0, 1, 2, 4, 8, 8, 4, 2, 1]

# tests/inputs/ci_multihead.json's heads (one graph head, three node heads)
# and the flagship's (one graph head, one node head, edge lengths).
CONFIGS = {
    "ci_multihead": dict(
        heads={
            "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 10,
                      "num_headlayers": 2, "dim_headlayers": [10, 10]},
            "node": {"num_headlayers": 2, "dim_headlayers": [10, 10], "type": "mlp"},
        },
        types=("graph", "node", "node", "node"), dims=(1, 1, 1, 1),
        weights=[20.0, 1.0, 1.0, 1.0], input_dim=3, edge_dim=None,
    ),
    "flagship": dict(
        heads={
            "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 32,
                      "num_headlayers": 2, "dim_headlayers": [32, 32]},
            "node": {"num_headlayers": 2, "dim_headlayers": [32, 32], "type": "mlp"},
        },
        types=("graph", "node"), dims=(1, 1), weights=[1.0, 1.0], input_dim=1,
        edge_dim=1,
    ),
}


def make_graphs(seed, count, cfg, n_lo=6, n_hi=16):
    """Port ``GraphSample``s with radius-graph edges, lengths and packed
    targets for ``cfg``'s heads; isolated nodes occur."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(count):
        n = int(rng.integers(n_lo, n_hi))
        pos = (rng.random((n, 3)) * (n ** (1 / 3))).astype(np.float32)
        x = rng.normal(size=(n, cfg["input_dim"])).astype(np.float32)
        parts, loc = [], [0]
        for k, htype in enumerate(cfg["types"]):
            part = np.asarray([x.sum()]) if htype == "graph" else x[:, k % x.shape[1]]
            parts.append(part)
            loc.append(loc[-1] + part.size)
        s = GraphSample(x=x, pos=pos, y=np.concatenate(parts).astype(np.float32),
                        y_loc=np.asarray([loc], np.int64))
        compute_edges(s, radius=1.2, max_neighbours=20)
        add_edge_lengths(s)
        graphs.append(s)
    return graphs


def to_jax_samples(graphs):
    return [JSample(**vars(s.clone())) for s in graphs]


def jax_model_and_variables(cfg, batch, hidden=16, layers=2, seed=0):
    """The reference model and its variables as numpy, with the batch-norm
    statistics and biases perturbed so no parameter sits at its trivial
    initial value."""
    model = jcreate(
        "PNA", cfg["input_dim"], hidden, cfg["dims"], cfg["types"], cfg["heads"],
        cfg["weights"], layers, edge_dim=cfg["edge_dim"], pna_deg=PNA_DEG,
    )
    variables = jax.device_get(init_model_variables(model, batch))
    rng = np.random.default_rng(seed + 100)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    variables = {c: perturb(dict(t)) for c, t in variables.items()}
    return model, variables


def port_model(cfg, variables, hidden=16, layers=2):
    model = create_model(
        "PNA", cfg["input_dim"], hidden, cfg["dims"], cfg["types"], cfg["heads"],
        cfg["weights"], layers, edge_dim=cfg["edge_dim"], pna_deg=PNA_DEG,
        device="cpu",
    )
    return load_flax_variables(model, variables)


def assert_outputs_close(t_out, j_out, types, node_mask, graph_mask):
    assert len(t_out) == len(j_out) == len(types)
    for k, (a, b, htype) in enumerate(zip(t_out, j_out, types)):
        rows = graph_mask if htype == "graph" else node_mask
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        a = a.detach().numpy()
        assert np.isfinite(a[rows]).all()
        np.testing.assert_allclose(
            a[rows], b[rows], rtol=RTOL, atol=ATOL, err_msg=f"head {k}"
        )


@pytest.mark.parametrize("pallas", [False, True], ids=["jax_default", "jax_csr_kernel"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def pytest_forward_and_loss_match_jax(monkeypatch, config, pallas):
    monkeypatch.delenv("HYDRAGNN_SEGMENT_SORTED", raising=False)
    if pallas:
        monkeypatch.setenv("HYDRAGNN_PALLAS", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_PALLAS", raising=False)
    cfg = CONFIGS[config]
    graphs = make_graphs(1, 6, cfg)
    edge_dim = cfg["edge_dim"]
    host = collate_graphs(graphs, cfg["types"], cfg["dims"], edge_dim=edge_dim)
    jb = jcollate.collate_graphs(to_jax_samples(graphs), cfg["types"], cfg["dims"], edge_dim=edge_dim)
    jmodel, variables = jax_model_and_variables(cfg, jb)
    j_out = jmodel.apply(variables, jb, train=False)
    j_total, j_rmses = jloss(j_out, jb, cfg["types"], jmodel.task_weights)

    model = port_model(cfg, variables)
    batch = GraphBatch.from_numpy(host, "cpu")
    with torch.inference_mode():
        t_out = model(batch)
        t_total, t_rmses = multihead_rmse_loss(t_out, batch, model.output_type, model.task_weights)
    assert_outputs_close(t_out, j_out, cfg["types"], host.node_mask, host.graph_mask)
    np.testing.assert_allclose(t_rmses.numpy(), np.asarray(j_rmses), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=RTOL, atol=ATOL)
    assert model.task_weights == pytest.approx(jmodel.task_weights)


def pytest_padding_does_not_change_real_rows():
    cfg = CONFIGS["flagship"]
    graphs = make_graphs(2, 5, cfg)
    jb = jcollate.collate_graphs(to_jax_samples(graphs), cfg["types"], cfg["dims"], edge_dim=1)
    _, variables = jax_model_and_variables(cfg, jb)
    model = port_model(cfg, variables)
    small = collate_graphs(graphs, cfg["types"], cfg["dims"], edge_dim=1)
    big = collate_graphs(graphs, cfg["types"], cfg["dims"], edge_dim=1,
                         num_nodes_pad=small.num_nodes_pad * 2,
                         num_edges_pad=small.num_edges_pad * 2, num_graphs_pad=9)
    with torch.inference_mode():
        a = model(GraphBatch.from_numpy(small, "cpu"))
        b = model(GraphBatch.from_numpy(big, "cpu"))
    g, n = len(graphs), int(small.node_mask.sum())
    np.testing.assert_allclose(b[0][:g].numpy(), a[0][:g].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(b[1][:n].numpy(), a[1][:n].numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def pytest_masked_batchnorm_matches_jax(train):
    """Eval mode normalises with the running statistics; train mode with the
    masked batch moments, and updates the running averages (momentum 0.9)."""
    from hydragnn_tpu.models.layers import MaskedBatchNorm as JBN

    from hydragnn_tpu_torch.models.layers import MaskedBatchNorm

    rng = np.random.default_rng(9)
    x = (rng.normal(size=(40, 6)) * 3 + 1).astype(np.float32)
    mask = rng.random(40) > 0.3
    jbn = JBN(6)
    variables = jax.device_get(jbn.init(jax.random.PRNGKey(0), x, mask, train=False))
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                   "bias": rng.normal(size=6).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=6).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)},
    }
    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    if train:
        want, mut = jbn.apply(variables, x, mask, train=True, mutable=["batch_stats"])
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, name).numpy(), np.asarray(mut["batch_stats"][key]),
                rtol=RTOL, atol=ATOL,
            )
    else:
        want = jbn.apply(variables, x, mask, train=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not got[~mask].any()


def _flagship_variables():
    cfg = CONFIGS["flagship"]
    graphs = make_graphs(3, 3, cfg)
    jb = jcollate.collate_graphs(to_jax_samples(graphs), cfg["types"], cfg["dims"], edge_dim=1)
    return cfg, jax_model_and_variables(cfg, jb)[1]


@pytest.mark.parametrize("fault", ["missing", "extra", "unknown_leaf", "shape", "collection"])
def pytest_weight_loader_rejects_mismatched_trees(fault):
    cfg, variables = _flagship_variables()
    model = port_model(cfg, variables)  # the intact tree loads
    before = {k: v.clone() for k, v in model.state_dict().items()}
    if fault == "missing":
        del variables["params"]["conv_1"]["lin"]["bias"]
    elif fault == "extra":
        variables["params"]["conv_9"] = {"lin": {"kernel": np.zeros((16, 16), np.float32)}}
    elif fault == "unknown_leaf":
        variables["batch_stats"]["bn_0"]["count"] = np.zeros((16,), np.float32)
    elif fault == "shape":
        variables["params"]["head_1"]["mlp"]["dense_0"]["kernel"] = np.zeros((17, 32), np.float32)
    else:
        variables["cache"] = {}
    with pytest.raises((KeyError, ValueError)):
        load_flax_variables(model, variables)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), f"{k} written before the tree was rejected"


def pytest_kernel_layout_is_transposed():
    cfg, variables = _flagship_variables()
    model = port_model(cfg, variables)
    kernel = variables["params"]["conv_0"]["post_nn"]["kernel"]
    np.testing.assert_array_equal(model.conv_0.post_nn.weight.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(
        model.bn_1.running_var.numpy(), variables["batch_stats"]["bn_1"]["var"]
    )


@pytest.mark.parametrize(
    "what", ["remat", "compute_dtype", "mlp_per_node", "conv_head", "default_device"]
)
def pytest_unported_options_raise(what):
    cfg = CONFIGS["flagship"]
    heads = {k: dict(v) for k, v in cfg["heads"].items()}
    model_type, kw = "PNA", dict(device="cpu")
    if what == "remat":
        kw["remat"] = True
    elif what == "compute_dtype":
        kw["compute_dtype"] = "bfloat16"
    elif what == "mlp_per_node":
        heads["node"]["type"] = "mlp_per_node"
    elif what == "conv_head":
        heads["node"]["type"] = "conv"
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default device is valid")
        kw = {}
    err = RuntimeError if what == "default_device" else NotImplementedError
    with pytest.raises(err, match="CUDA" if what == "default_device" else "ROADMAP"):
        create_model(model_type, 1, 16, cfg["dims"], cfg["types"], heads, cfg["weights"], 2,
                     edge_dim=1, pna_deg=PNA_DEG, **kw)


def pytest_seeded_init_is_reproducible():
    cfg = CONFIGS["flagship"]
    args = ("PNA", 1, 16, cfg["dims"], cfg["types"], cfg["heads"], cfg["weights"], 2)
    kw = dict(edge_dim=1, pna_deg=PNA_DEG, device="cpu")
    a = create_model(*args, generator=torch.Generator().manual_seed(7), **kw)
    b = create_model(*args, generator=torch.Generator().manual_seed(7), **kw)
    c = create_model(*args, generator=torch.Generator().manual_seed(8), **kw)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_1.pre_nn.weight"], sc["conv_1.pre_nn.weight"])
    # flax's LeCun truncated normal: std 1/sqrt(fan_in), cut at 2 sigma.
    w = sa["conv_1.post_nn.weight"]
    fan_in = w.shape[1]
    assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
