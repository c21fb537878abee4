"""Port parity, training: the port's train step, optimizers, non-finite
guard, plateau scheduler, data loader and epoch loop against the JAX
package's, on a small flagship-shaped model (PNA, hidden 8, 2 conv layers,
a graph head and an ``mlp`` node head, 6 graphs per batch) whose weights
come from the JAX model through ``load_flax_variables``, on the CPU.

Tolerance rtol=1e-4, atol=1e-5: f32 sums in another order. Gradients are
compared leaf by leaf after the flax → torch name map (Dense kernels
transposed). Adam's update ``m / (sqrt(v) + eps)`` of a gradient that is
zero analytically and rounding noise in practice (each conv's last bias,
which the train-mode batch norm right after it cancels) is a ratio of two
noises, up to ~0.1·lr apart on the two sides, and it reaches the running
means. So the optimizers are held to optax on identical gradients, and
full train steps are compared end to end with SGD."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from hydragnn_tpu.graphs import collate as jcollate
from hydragnn_tpu.preprocess.dataloader import GraphDataLoader as JLoader
from hydragnn_tpu.train import TrainingDriver as JDriver
from hydragnn_tpu.train import train_validate_test as j_tvt
from hydragnn_tpu.train.trainer import _loss_and_metrics, create_train_state, make_train_step
from hydragnn_tpu.utils import optimizer as jopt

from hydragnn_tpu_torch.graphs import GraphBatch, collate_graphs
from hydragnn_tpu_torch.preprocess import GraphDataLoader
from hydragnn_tpu_torch.train import TrainingDriver, loss_and_grads, train_step, train_validate_test
from hydragnn_tpu_torch.utils import optimizer as topt
from hydragnn_tpu_torch.utils.flax_weights import flax_to_state_dict

from test_torch_port_model import (
    CONFIGS,
    jax_model_and_variables,
    make_graphs,
    port_model,
    to_jax_samples,
)

RTOL, ATOL = 1e-4, 1e-5
HIDDEN, LAYERS = 8, 2
CFG = CONFIGS["flagship"]


def _route(monkeypatch, pallas):
    monkeypatch.delenv("HYDRAGNN_SEGMENT_SORTED", raising=False)
    monkeypatch.delenv("HYDRAGNN_PALLAS_CSR", raising=False)
    if pallas:
        monkeypatch.setenv("HYDRAGNN_PALLAS", "1")
    else:
        monkeypatch.delenv("HYDRAGNN_PALLAS", raising=False)


def _setup(seed=1, count=6):
    graphs = make_graphs(seed, count, CFG)
    host = collate_graphs(graphs, CFG["types"], CFG["dims"], edge_dim=1)
    jb = jcollate.collate_graphs(to_jax_samples(graphs), CFG["types"], CFG["dims"], edge_dim=1)
    jmodel, variables = jax_model_and_variables(CFG, jb, hidden=HIDDEN, layers=LAYERS)
    model = port_model(CFG, variables, hidden=HIDDEN, layers=LAYERS)
    return graphs, host, jb, jmodel, variables, model


def _named(tree, collection="params"):
    """A flax tree → {torch state_dict name: numpy array}."""
    return {k: v.numpy() for k, v in flax_to_state_dict({collection: jax.device_get(tree)}).items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize(
    "route", ["jax_default", "jax_kernels", "jax_kernels_no_pointers"]
)
def pytest_train_step_gradients_match_jax(monkeypatch, route):
    """Loss, every parameter's gradient and the updated batch-norm
    statistics of one train-mode step against ``jax.value_and_grad`` of the
    reference's ``_loss_and_metrics``; the last case runs both sides on a
    batch without ``row_ptr``/``graph_ptr`` (the port's unsorted-id kernel,
    the JAX one-hot kernels)."""
    _route(monkeypatch, route != "jax_default")
    _, host, jb, jmodel, variables, model = _setup()
    batch = GraphBatch.from_numpy(host, "cpu")
    if route == "jax_kernels_no_pointers":
        jb = jb.replace(row_ptr=None, graph_ptr=None)
        batch.row_ptr = batch.graph_ptr = None
    (j_loss, (j_stats, j_rmses)), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: _loss_and_metrics(jmodel, p, variables["batch_stats"], b, jax.random.PRNGKey(0)),
        has_aux=True,
    ))(variables["params"], jb)
    loss, rmses, grads = loss_and_grads(model, batch)
    _close(float(loss), float(j_loss), "loss")
    _close(rmses.numpy(), np.asarray(j_rmses), "rmses")
    want = _named(j_grads)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        _close(g.numpy(), want[name], name)
    stats = _named(j_stats, "batch_stats")
    for name, buf in model.named_buffers():
        _close(buf.numpy(), stats[name], name)


def pytest_masked_batchnorm_train_gradient_matches_jax():
    """Train-mode ``MaskedBatchNorm``: the output, the updated running
    statistics (flax's mutable ``batch_stats``) and the gradients through
    the masked batch moments to the input, scale and bias."""
    from hydragnn_tpu.models.layers import MaskedBatchNorm as JBN

    from hydragnn_tpu_torch.models.layers import MaskedBatchNorm

    rng = np.random.default_rng(31)
    x = (rng.normal(size=(40, 6)) * 3 + 1).astype(np.float32)
    mask = rng.random(40) > 0.3
    w = rng.normal(size=(40, 6)).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                   "bias": rng.normal(size=6).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=6).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)},
    }
    jbn = JBN(6)

    def jloss(params, xj):
        y, mut = jbn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           xj, mask, train=True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jg_params, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    bn = MaskedBatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = bn(tx, torch.from_numpy(mask))
    gx, gw, gb = torch.autograd.grad((y * torch.from_numpy(w)).sum(), (tx, bn.weight, bn.bias))
    _close(y.detach().numpy(), np.asarray(jy), "output")
    _close(bn.running_mean.numpy(), np.asarray(jstats["mean"]), "running mean")
    _close(bn.running_var.numpy(), np.asarray(jstats["var"]), "running var")
    _close(gx.numpy(), np.asarray(jg_x), "d input")
    _close(gw.numpy(), np.asarray(jg_params["scale"]), "d scale")
    _close(gb.numpy(), np.asarray(jg_params["bias"]), "d bias")
    assert not gx.numpy()[~mask].any()


def _adam_moments(opt_state):
    """The ScaleByAdamState inside the reference's injected-LR chain."""
    return next(s for s in opt_state.inner_state if hasattr(s, "mu"))


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def pytest_three_steps_match_optax(name):
    """The optimizer's semantics: three steps from the same parameters with
    the same gradients (seeded, of mixed scales, one leaf all zero) through
    the reference's optax transformation and the port's optimizer;
    parameters and (Adam) both moments after every step."""
    _, _, _, _, variables, model = _setup()
    lr = 0.01
    jo = jopt.select_optimizer(name, lr)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = jo.init(params)
    to = topt.select_optimizer(model, name, lr)
    rng = np.random.default_rng(11)
    for k in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32),
            variables["params"],
        )
        grads["conv_0"]["lin"]["bias"] = np.zeros_like(grads["conv_0"]["lin"]["bias"])
        updates, opt_state = jo.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        named = _named(grads)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(named[n])
        to.step()
        want = _named(params)
        for n, p in model.named_parameters():
            _close(p.detach().numpy(), want[n], f"step {k} {n}")
        if name != "sgd":
            adam = _adam_moments(opt_state)
            mu, nu = _named(adam.mu), _named(adam.nu)
            for n, p in model.named_parameters():
                _close(to.state[p]["exp_avg"].numpy(), mu[n], f"step {k} mu {n}")
                _close(to.state[p]["exp_avg_sq"].numpy(), nu[n], f"step {k} nu {n}")
    assert topt.get_learning_rate(to) == jopt.get_learning_rate(opt_state)


def pytest_three_sgd_train_steps_match_jax():
    """Three full train steps (forward, backward, SGD update) on three
    batches against the reference's compiled step: the loss, every
    parameter and the batch norms' running statistics after every step."""
    graphs = make_graphs(2, 18, CFG)
    _, _, _, jmodel, variables, model = _setup()
    jo = jopt.select_optimizer("sgd", 0.05)
    state = create_train_state(jmodel, variables, jo)
    jstep = make_train_step(jmodel, jo, donate=False)
    to = topt.select_optimizer(model, "sgd", 0.05)
    pads = dict(num_nodes_pad=256, num_edges_pad=4096, num_graphs_pad=7, edge_dim=1)
    for k in range(3):
        gs = graphs[6 * k : 6 * k + 6]
        jb = jcollate.collate_graphs(to_jax_samples(gs), CFG["types"], CFG["dims"], **pads)
        host = collate_graphs(gs, CFG["types"], CFG["dims"], **pads)
        state, jm = jstep(state, jb, jax.random.PRNGKey(0))
        m = train_step(model, to, GraphBatch.from_numpy(host, "cpu"))
        _close(float(m["loss"]), float(jm["loss"]), f"step {k} loss")
        _close(m["rmses"].numpy(), np.asarray(jm["rmses"]), f"step {k} rmses")
        assert float(m["count"]) == float(jm["count"]) == 6.0
        want = _named(state.params)
        for n, p in model.named_parameters():
            _close(p.detach().numpy(), want[n], f"step {k} {n}")
        stats = _named(state.batch_stats, "batch_stats")
        for n, b in model.named_buffers():
            _close(b.numpy(), stats[n], f"step {k} {n}")


def pytest_optimizer_table_and_freeze():
    """The reference's names: three ported, the rest refused naming their
    ROADMAP item, an unknown name a ValueError. ``freeze_conv`` leaves the
    encoder out of the optimizer (no update, no weight decay)."""
    _, _, _, _, _, model = _setup()
    for name in ("adadelta", "adagrad", "adamax", "rmsprop", "sparseadam", "lbfgs"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            topt.select_optimizer(model, name, 0.01)
    with pytest.raises(ValueError, match="not defined"):
        topt.select_optimizer(model, "nadam", 0.01)
    opt = topt.select_optimizer(model, "AdamW", 0.01, freeze_conv=True)
    kept = {id(p) for g in opt.param_groups for p in g["params"]}
    for n, p in model.named_parameters():
        frozen = n.startswith(("conv_", "bn_"))
        assert (id(p) in kept) != frozen, n
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step(model, opt, GraphBatch.from_numpy(_setup()[1], "cpu"))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == n.startswith(("conv_", "bn_")), n
    topt.set_learning_rate(opt, 0.003)
    assert topt.get_learning_rate(opt) == float(np.float32(0.003))


def pytest_guard_skips_a_nan_batch():
    """A NaN batch under the guard leaves parameters, optimizer state and
    the batch norms' running statistics as they were, carries zero weight
    and reports ``bad``; the next finite batch steps normally."""
    _, host, _, _, _, model = _setup()
    opt = topt.select_optimizer(model, "adamw", 0.01)
    batch = GraphBatch.from_numpy(host, "cpu")
    train_step(model, opt, batch, guard=True)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    moments = {n: {k: v.clone() for k, v in opt.state[p].items()} for n, p in model.named_parameters()}
    bad = GraphBatch.from_numpy(host, "cpu")
    bad.node_features = bad.node_features.clone()
    bad.node_features[0, 0] = float("nan")
    m = train_step(model, opt, bad, guard=True)
    assert float(m["bad"]) == 1.0 and float(m["count"]) == 0.0 and float(m["loss"]) == 0.0
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
        for k, v in opt.state[p].items():
            assert torch.equal(v, moments[n][k]), (n, k)
    for n, b in model.named_buffers():
        assert torch.equal(b, bufs[n]), n
    m = train_step(model, opt, batch, guard=True)
    assert float(m["bad"]) == 0.0 and float(m["count"]) == 6.0
    assert not torch.equal(model.conv_0.pre_nn.weight, params["conv_0.pre_nn.weight"])


def pytest_driver_refuses_the_rollback_policy():
    """``fault_tolerance`` enabled asks for the reference's skip/rollback
    policy, which is not ported: the driver refuses it and names its ROADMAP
    item. Disabled, it trains as without it."""
    _, host, _, _, _, model = _setup()
    opt = topt.select_optimizer(model, "sgd", 0.01)
    with pytest.raises(NotImplementedError, match="A8"):
        TrainingDriver(model, opt, device="cpu",
                       fault_tolerance={"enabled": True, "max_bad_steps": 2})
    driver = TrainingDriver(model, opt, device="cpu", fault_tolerance={"enabled": False})
    loss, _ = driver.train_epoch([host])
    assert np.isfinite(loss)


def pytest_plateau_scheduler_matches_jax():
    rng = np.random.default_rng(5)
    metrics = list(np.concatenate([np.linspace(1.0, 0.5, 6), np.full(9, 0.5),
                                   0.5 - 1e-5 * rng.random(8), np.linspace(0.49, 0.3, 5),
                                   np.full(20, 0.3)]))
    for kw in ({}, {"patience": 2, "cooldown": 1}, {"threshold_mode": "abs", "threshold": 0.01}):
        j, t = jopt.ReduceLROnPlateau(**kw), topt.ReduceLROnPlateau(**kw)
        jl = tl = 0.01
        for v in metrics:
            jl, tl = j.step(float(v), jl), t.step(float(v), tl)
            assert jl == tl
            assert j.state_dict() == t.state_dict()
        assert tl < 0.01


def _loaders(graphs, cls, seed=3, shuffle=True, batch_size=4):
    return cls(graphs if cls is GraphDataLoader else to_jax_samples(graphs), batch_size,
               shuffle=shuffle, seed=seed, head_types=CFG["types"], head_dims=CFG["dims"],
               edge_dim=1)


def pytest_data_loader_matches_jax():
    """Same samples, seed and epoch: the same batches in the same order,
    every array equal, for epochs 0-2, shuffled and not."""
    graphs = make_graphs(7, 15, CFG)
    for shuffle in (True, False):
        tl, jl = _loaders(graphs, GraphDataLoader, shuffle=shuffle), _loaders(graphs, JLoader, shuffle=shuffle)
        assert tl.pad_sizes == jl.pad_sizes and len(tl) == len(jl) == 4
        for epoch in range(3):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            tb, jb = list(tl), list(jl)
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                for field in ("node_features", "edge_features", "senders", "receivers",
                              "node_graph", "node_mask", "edge_mask", "graph_mask",
                              "row_ptr", "graph_ptr"):
                    np.testing.assert_array_equal(getattr(a, field), np.asarray(getattr(b, field)))
                for x, y in zip(a.targets, b.targets):
                    np.testing.assert_array_equal(x, np.asarray(y))
    for bad in ({"num_shards": 2}, {"num_buckets": 2}, {"reshuffle": "batch"},
                {"packing": True}, {"skip_budget": 1}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GraphDataLoader(graphs, 4, **bad)


def pytest_train_validate_test_history_matches_jax():
    """Two epochs of the epoch loop (AdamW, the plateau scheduler) from the
    same weights and loaders: the six history series against the JAX run."""
    graphs = make_graphs(8, 20, CFG)
    _, _, _, jmodel, variables, model = _setup()
    parts = (graphs[:12], graphs[12:16], graphs[16:])
    jo = jopt.select_optimizer("adamw", 0.001)
    jdriver = JDriver(jmodel, jo, create_train_state(jmodel, variables, jo))
    j_hist = j_tvt(jdriver, *(_loaders(p, JLoader) for p in parts), 2,
                   scheduler=jopt.ReduceLROnPlateau())
    driver = TrainingDriver(model, topt.select_optimizer(model, "adamw", 0.001), device="cpu")
    t_hist = train_validate_test(driver, *(_loaders(p, GraphDataLoader) for p in parts), 2,
                                 scheduler=topt.ReduceLROnPlateau())
    assert sorted(t_hist) == sorted(j_hist)
    for key in t_hist:
        _close(np.asarray(t_hist[key], dtype=np.float64), np.asarray(j_hist[key], dtype=np.float64), key)
    assert all(np.isfinite(v).all() for v in map(np.asarray, t_hist.values()))


@pytest.mark.parametrize("what", ["mesh", "bf16", "fault_plan", "writer", "profiler",
                                  "visualizer", "checkpoint", "default_device"])
def pytest_unported_training_options_raise(what):
    _, host, _, _, _, model = _setup()
    opt = topt.select_optimizer(model, "sgd", 0.01)
    if what == "default_device":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA"):
            TrainingDriver(model, opt)
        return
    kw = {"mesh": {"mesh": object()}, "bf16": {"precision": "bf16"},
          "fault_plan": {"fault_plan": object()}}.get(what)
    if kw is not None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainingDriver(model, opt, device="cpu", **kw)
        return
    driver = TrainingDriver(model, opt, device="cpu")
    kw = {"writer": {"writer": object()}, "profiler": {"profiler": object()},
          "visualizer": {"visualizer": object()}, "checkpoint": {"checkpoint_name": "x"}}[what]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_validate_test(driver, [host], [host], [host], 1, **kw)
