#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``hydragnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device and build: the card's name and power limit (``nvidia-smi``), and
   the CUDA kernels built from ``hydragnn_tpu_torch/ops/csrc`` with
   ``nvcc``, one compiler per source, all started together;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the flagship model gives it and at edge cases: K1 (CSR runs, and every
   lane-group width), the unsorted-id kernel (K2/K3: batches without CSR
   pointers), in 2c the block-skip kernel (K4: batches without CSR pointers
   under ``HYDRAGNN_PALLAS_SKIP=1``, also against K2/K3), and in 2d K5, the
   CSR stats kernel (PNA's sum, mean, std, count, min and max in one
   launch), also against f64;
3. serving: the flagship PNA model (hidden 64, 3 layers, graph + node
   heads, random weights from seed 0) behind ``InferenceEngine`` answers
   three 256-graph ``predict`` calls and 8 lone ``submit`` calls; every
   batch forward must launch K5 3 times (one per layer) and K1 once (the
   readout pool) and call no ``scatter_reduce``, and the same model on the
   CPU must agree; then the same batch without ``row_ptr``/``graph_ptr``:
   7 launches of the unsorted-id kernel and none of K1 or K5, outputs equal
   to the CSR forward;
4. full width: hidden 256 on one 512-graph batch, the same checks, with and
   without CSR pointers (the F > 64 launches of the unsorted-id kernel);
5. training: ``train_validate_test`` over ``TrainingDriver(...,
   device="cuda")`` for 3 epochs of 8 train, 2 val and 2 test batches of 256
   graphs (AdamW, ``ReduceLROnPlateau``): the losses finite and falling, 3
   K5 + 1 K1 launches per forward and none from the backward; on each train
   batch one step's loss (rtol 1e-5) and gradients (rtol 1e-4 + atol 1e-5 x
   each tensor's largest gradient, see :func:`grad_gap`, and for the
   tensors f32 cannot resolve the f64 step with their derived f32 bound,
   see :func:`step_card_vs_cpu`) on the card against the CPU, the CPU's
   backward taking the card's side of every ReLU and min/max kink (see
   :class:`Kinks`), and on a batch without CSR pointers against the CSR
   step;
6. times: each kernel, its plain version, the library calls (``index_add_``,
   and for K1 ``torch.segment_reduce``; for K5 the parent's bundle of two K1
   calls, elementwise ops and ``scatter_reduce``) in turns by CUDA events and
   by profiler device time, and the memory bound, at the flagship shapes
   (K4 beside K2/K3 on the same ids), the engine's batch latency, the train
   step, and the device's busy time and idle share of a forward and of a
   train step (``torch.profiler``);
7. the other conv families (SAGE, GIN, MFC, GAT, CGCNN) at the flagship's
   widths: each serves a 256-graph batch through ``InferenceEngine``
   (card vs CPU), runs the same batch without CSR pointers under
   ``HYDRAGNN_PALLAS_SKIP=1`` (K4 only), takes one train step card vs CPU
   (GAT's dropout at 0) and trains 3 epochs through ``TrainingDriver``
   with its defaults, its loss falling.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA device; without one it
exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The flagship model and its traffic (PNA multi-task, graph + node heads).
HEADS = {
    "graph": {
        "num_sharedlayers": 2,
        "dim_sharedlayers": 32,
        "num_headlayers": 2,
        "dim_headlayers": [32, 32],
    },
    "node": {"num_headlayers": 2, "dim_headlayers": [32, 32], "type": "mlp"},
}
TYPES = ("graph", "node")
DIMS = (1, 1)
PNA_DEG = [0, 0, 1, 2, 4, 8, 8, 4, 2, 1]
LAYERS = 3
N_LO, N_HI = 12, 26  # nodes per graph, QM9-like
RADIUS, MAX_NEIGHBOURS = 1.2, 20

# H100 SXM data-sheet peaks (the bound is against these, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
RTOL, ATOL = 1e-4, 1e-5  # port on the card vs the same model on the CPU
ROUNDING_LEVEL = 1e-6  # a gradient this far below the step's largest is noise
KERNELS = ("csr_segment", "csr_stats", "segment_sum_count", "segment_skip")
KERNEL_CERT_FWD = 5e-4  # the reference's KERNEL_CERT_GATE.fwd (precision/tolerance.py)
TRAIN_BATCHES, EVAL_BATCHES, EPOCHS, BATCH_GRAPHS = 8, 2, 3, 256
FAMILIES = ("SAGE", "GIN", "MFC", "GAT", "CGCNN")
# Phase 2's lane-group shapes for K1: widths and run lengths around every
# sub-group width and piece size, and a 20000-entry run.
LANE_F = (1, 2, 3, 8, 16, 32, 33, 64, 65, 128, 384)
LANE_RUNS = (0, 1, 31, 32, 33, 128, 129, 0, 2, 20000, 7)
FAMILY_TRAIN_BATCHES = 4
GAT_HEADS = 6


def bare_launches(family):
    """(sum, count) kernel calls of one forward without CSR pointers: one
    aggregation per layer (GAT two: the softmax denominator and the weighted
    sum; PNA two: the mean and the centred-std passes) and the readout
    pool."""
    return (2 if family in ("GAT", "PNA") else 1) * LAYERS + 1


def launches_per_forward(family):
    """Kernel launches of one forward with CSR pointers: PNA's stats bundle
    (sum, mean, std, min, max) is one K5 launch per layer and the readout
    one K1 launch; every aggregation of the other families is K1."""
    if family == "PNA":
        return {"k1": 1, "k5": LAYERS}
    return {"k1": bare_launches(family), "k5": 0}


LAUNCHES_PER_FORWARD = launches_per_forward("PNA")
BARE_PER_FORWARD = bare_launches("PNA")


def make_graphs(count, rng):
    from hydragnn_tpu_torch.graphs import GraphSample
    from hydragnn_tpu_torch.preprocess import add_edge_lengths, compute_edges

    graphs = []
    for _ in range(count):
        n = int(rng.integers(N_LO, N_HI))
        pos = rng.random((n, 3)).astype(np.float32) * (n ** (1 / 3))
        x = rng.normal(size=(n, 1)).astype(np.float32)
        y = np.concatenate([[x.sum()], x[:, 0]]).astype(np.float32)
        s = GraphSample(x=x, pos=pos, y=y, y_loc=np.array([[0, 1, 1 + n]], dtype=np.int64))
        compute_edges(s, radius=RADIUS, max_neighbours=MAX_NEIGHBOURS)
        add_edge_lengths(s)
        graphs.append(s)
    return graphs


def unlabeled(graphs):
    from hydragnn_tpu_torch.graphs import GraphSample

    return [GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index, edge_attr=s.edge_attr)
            for s in graphs]


def build_model(hidden, device, family="PNA", **kw):
    import torch

    from hydragnn_tpu_torch.models import create_model

    return create_model(
        family, 1, hidden, DIMS, TYPES, HEADS, [1.0, 1.0], LAYERS,
        edge_dim=1, pna_deg=PNA_DEG, max_neighbours=MAX_NEIGHBOURS, device=device,
        generator=torch.Generator().manual_seed(0), **kw,
    )


@contextlib.contextmanager
def skip_switch():
    """``HYDRAGNN_PALLAS_SKIP=1`` inside the block, as it was after."""
    before = os.environ.get("HYDRAGNN_PALLAS_SKIP")
    os.environ["HYDRAGNN_PALLAS_SKIP"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["HYDRAGNN_PALLAS_SKIP"]
        else:
            os.environ["HYDRAGNN_PALLAS_SKIP"] = before


def check_outputs(results, graphs, where):
    if len(results) != len(graphs):
        raise AssertionError(f"{where}: {len(results)} results for {len(graphs)} graphs")
    for g, (res, s) in enumerate(zip(results, graphs)):
        shapes = [np.shape(r) for r in res]
        if shapes != [(DIMS[0],), (s.num_nodes, DIMS[1])]:
            raise AssertionError(f"{where}: graph {g} output shapes {shapes}")
        if not all(np.isfinite(r).all() for r in res):
            raise AssertionError(f"{where}: graph {g} has non-finite outputs")


def max_rel_gap(got, want):
    """max |got - want| / (ATOL + RTOL |want|) over every output; <= 1 passes."""
    worst = 0.0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            worst = max(worst, float(np.max(np.abs(x - y) / (ATOL + RTOL * np.abs(y)))))
    return worst


def zero_counts():
    """Every kernel's launch count to 0."""
    from hydragnn_tpu_torch.ops import csr_segment
    from hydragnn_tpu_torch.ops import segment_sum_count as ssc

    csr_segment.KERNEL_LAUNCHES = 0
    csr_segment.STATS_LAUNCHES = 0
    ssc.KERNEL_LAUNCHES = 0
    ssc.WIDE_LAUNCHES = 0
    ssc.SKIP_LAUNCHES = 0


def read_counts():
    """Launches since :func:`zero_counts`: K1, K5, the unsorted-id kernel
    (and of those the launches at F > 64), and the block-skip kernel K4."""
    from hydragnn_tpu_torch.ops import csr_segment
    from hydragnn_tpu_torch.ops import segment_sum_count as ssc

    return {"k1": csr_segment.KERNEL_LAUNCHES, "k5": csr_segment.STATS_LAUNCHES,
            "k2": ssc.KERNEL_LAUNCHES, "wide": ssc.WIDE_LAUNCHES, "k4": ssc.SKIP_LAUNCHES}


def counted(run, where, k1=0, k2=0, wide=0, k4=0, k5=0):
    """``run()`` with every count zeroed just before; raises unless the
    counts read just after are exactly (k1, k5, k2, wide, k4)."""
    zero_counts()
    out = run()
    got = read_counts()
    want = {"k1": k1, "k5": k5, "k2": k2, "wide": wide, "k4": k4}
    if got != want:
        raise AssertionError(f"{where}: kernel launches {got} != {want}")
    return out, got


def serve_with_counts(engine, calls, per_forward=LAUNCHES_PER_FORWARD):
    """Run ``calls(engine)`` with the kernels' launch counts zeroed just
    before; returns (result, the counts, batch forwards)."""
    before = engine.batches_run
    zero_counts()
    out = calls(engine)
    counts = read_counts()
    batches = engine.batches_run - before
    want = {"k1": per_forward["k1"] * batches, "k5": per_forward["k5"] * batches,
            "k2": 0, "wide": 0, "k4": 0}
    if batches == 0 or counts != want:
        raise AssertionError(
            f"kernel launches {counts} != {per_forward} x {batches} batch forwards"
        )
    return out, counts, batches


def as_double(batch):
    """The same CPU batch with its float fields in float64."""
    out = copy.copy(batch)
    out.node_features = batch.node_features.double()
    if batch.edge_features is not None:
        out.edge_features = batch.edge_features.double()
    out.targets = tuple(t.double() for t in batch.targets)
    return out


def without_pointers(batch):
    """The same tensor batch with ``row_ptr`` and ``graph_ptr`` dropped."""
    bare = copy.copy(batch)
    bare.row_ptr = bare.graph_ptr = None
    return bare


def real_rows(outputs, host):
    """Per-head numpy outputs at real rows (graph heads: graph_mask, node
    heads: node_mask)."""
    return [o.detach().cpu().numpy()[host.graph_mask if t == "graph" else host.node_mask]
            for o, t in zip(outputs, TYPES)]


def tensor_gaps(got, want, names, f32_bound=None):
    """Per parameter, max over its gradient entries of |got - want| / (1e-4
    |want| + 1e-5 max|g| + B); <= 1 passes. ``max|g|`` is the tensor's own
    largest entry of ``want``, except for a tensor whose gradient is at
    rounding level (its largest entry below ``ROUNDING_LEVEL`` x the step's
    largest): it is held to the step's largest entry. Each conv's last bias
    is such a tensor: its gradient is zero analytically (the train-mode
    batch norm after it subtracts the batch mean), so what either side
    holds is rounding noise. ``B`` is 0, or for a tensor in ``f32_bound``
    that entry's f32 summation bound (:func:`f32_bounds`). Returns ([(name,
    gap)], the rounding-level tensors)."""
    got = [a.detach().double().cpu() for a in got]
    want = [b.detach().double().cpu() for b in want]
    step = max(float(b.abs().max()) for b in want)
    gaps, noise = [], []
    for name, a, b in zip(names, got, want):
        own = float(b.abs().max())
        if own < ROUNDING_LEVEL * step:
            noise.append(f"{name} ({own / step:.1e})")
            own = step
        tol = 1e-4 * b.abs() + 1e-5 * own
        if f32_bound and name in f32_bound:
            tol = tol + f32_bound[name].double().cpu()
        gaps.append((name, float(((a - b).abs() / tol).max())))
    return gaps, noise


def grad_gap(got, want, names, f32_bound=None):
    """(the largest of :func:`tensor_gaps`, the parameter where it is
    reached, the rounding-level tensors). The backward's ``index_add_``
    (the gather of the message inputs) sums in a varying order on the
    card."""
    gaps, noise = tensor_gaps(got, want, names, f32_bound)
    where, worst = max(reversed(gaps), key=lambda g: g[1])
    return worst, where, noise


# A tensor is f32-limited where the CPU's own f32 gradient misses the f64
# gradient of the same step by more than this share of the tolerance.
F32_LIMITED_SHARE = 1.0 / 6.0
F32_UNIT = 2.0 ** -24  # f32 unit roundoff


def tree_depth(n):
    """⌈log2 n⌉: the rounding depth of a pairwise (tree) sum of ``n`` terms."""
    return max(1, (int(n) - 1).bit_length())


def f32_bounds(model, run):
    """``{parameter name: bound}``: each gradient entry's f32 summation
    bound ``⌈log2 n⌉ x 2^-24 x Σ|terms|`` over the ``n`` terms that make it,
    the first-order bound of a pairwise (tree) sum, read from the f64 step
    ``run()`` on ``model`` with hooks: a linear layer's weight ``⌈log2 n⌉
    2^-24 (|dy|ᵀ|x|)`` and bias ``⌈log2 n⌉ 2^-24 Σ|dy|`` (``n`` rows, ``x``
    its input, ``dy`` the cotangent of its output; summed over calls),
    GIN's ``eps`` ``⌈log2 n⌉ 2^-24 Σ|x||dh|`` (``h = (1 + eps) x + agg``,
    ``n`` entries of ``x``). The card's reductions (GEMM tiles, column
    sums) are trees of short serial chains, not documented term by term:
    the pairwise depth models them; a serial order of all ``n`` terms could
    reach ``n`` in its place."""
    import torch

    from hydragnn_tpu_torch.models.convs import GINConv

    bounds, handles = {}, []

    def add(name, bound):
        bounds[name] = bounds[name] + bound if name in bounds else bound

    def linear(prefix, inputs):
        def forward(module, args, out):
            inputs.append(args[0].detach())

        def backward(module, grad_in, grad_out):
            x = inputs.pop().abs().reshape(-1, module.in_features)
            dy = grad_out[0].detach().abs().reshape(-1, module.out_features)
            depth = tree_depth(x.shape[0]) * F32_UNIT
            add(f"{prefix}.weight", depth * (dy.t() @ x))
            add(f"{prefix}.bias", depth * dy.sum(0))

        return forward, backward

    def gin(prefix, inputs):
        def forward(module, args):
            inputs.append(args[0].detach())

        def backward(module, grad_in, grad_out):
            x = inputs.pop()
            depth = tree_depth(x.numel()) * F32_UNIT
            add(f"{prefix}.eps", depth * (x.abs() * grad_in[0].detach().abs()).sum())

        return forward, backward

    for prefix, module in model.named_modules():
        if isinstance(module, torch.nn.Linear):
            forward, backward = linear(prefix, [])
            handles += [module.register_forward_hook(forward),
                        module.register_full_backward_hook(backward)]
        elif isinstance(module, GINConv):
            forward, backward = gin(prefix, [])
            handles += [module.register_forward_pre_hook(forward),
                        module.mlp_0.register_full_backward_hook(backward)]
    try:
        with warnings.catch_warnings():
            # A first layer's input needs no gradient; its hook still sees dy.
            warnings.filterwarnings("ignore", message="Full backward hook is firing")
            out = run()
    finally:
        for h in handles:
            h.remove()
    return out, bounds


def masked_ids(ids, mask):
    """int64 ids with -1 at the rows ``mask`` drops."""
    import torch

    ids = ids.long()
    return ids if mask is None else torch.where(mask, ids, torch.full_like(ids, -1))


def extrema_selections(data, ids, mn, mx):
    """``[E, F]`` bools: the rows that attain their segment's min, and its
    max; the reference's ``_extrema_bwd`` hands each of them the full
    cotangent."""
    idx = ids.long().clamp(0, max(mn.shape[0] - 1, 0))
    valid = (ids >= 0)[:, None]
    return (valid & (data == mn.index_select(0, idx)),
            valid & (data == mx.index_select(0, idx)))


def _replayed_functions():
    import torch

    class ReplayedExtrema(torch.autograd.Function):
        """``segment_extrema``'s forward; its backward hands the cotangents to
        the given rows instead of to the rows that attain the extrema here."""

        @staticmethod
        def forward(ctx, data, ids, num_segments, sel_min, sel_max, extrema):
            mn, mx = extrema(data, ids, num_segments)
            ctx.save_for_backward(ids, sel_min, sel_max)
            ctx.num_segments = num_segments
            return mn, mx

        @staticmethod
        def backward(ctx, d_mn, d_mx):
            ids, sel_min, sel_max = ctx.saved_tensors
            idx = ids.long().clamp(0, max(ctx.num_segments - 1, 0))
            zero = torch.zeros((), dtype=d_mn.dtype)
            d_data = (torch.where(sel_min, d_mn.index_select(0, idx), zero)
                      + torch.where(sel_max, d_mx.index_select(0, idx), zero))
            return d_data, None, None, None, None, None

    class ReplayedRelu(torch.autograd.Function):
        """ReLU whose backward passes the cotangent where ``active`` says."""

        @staticmethod
        def forward(ctx, x, active):
            ctx.save_for_backward(active)
            return x.clamp_min(0)

        @staticmethod
        def backward(ctx, d_y):
            (active,) = ctx.saved_tensors
            return torch.where(active, d_y, torch.zeros((), dtype=d_y.dtype)), None

    class ReplayedLeakyRelu(torch.autograd.Function):
        """Leaky ReLU whose backward takes slope 1 where ``active`` says and
        ``slope`` elsewhere."""

        @staticmethod
        def forward(ctx, x, active, slope):
            ctx.save_for_backward(active)
            ctx.slope = slope
            return torch.where(x > 0, x, x * slope)

        @staticmethod
        def backward(ctx, d_y):
            (active,) = ctx.saved_tensors
            return torch.where(active, d_y, d_y * ctx.slope), None, None

    return ReplayedExtrema, ReplayedRelu, ReplayedLeakyRelu


class Kinks:
    """The model is piecewise smooth: ReLU and leaky ReLU bend at 0, and
    min/max change rows where two rows of a segment tie. A pre-activation within rounding
    of 0, or a near tie, that f32 rounding puts on one side on the card and
    on the other side on the CPU (their matmuls add in different orders)
    moves a whole cotangent: both gradients are the reference's
    subgradient, yet they differ far beyond rounding. So the card's train
    step is held to a CPU step that takes the card's side at every kink.
    Inside :meth:`record`, each ``torch.relu`` and
    ``torch.nn.functional.leaky_relu`` call keeps which entries are active
    and each min/max call (``csr_segment_stats`` with extrema, K5's route
    with CSR pointers, or ``segment_extrema`` without them) which rows
    attain the extrema (in call order, on the CPU); inside :meth:`replay`
    each backward takes the recorded ones (K5's min and max pass through a
    function whose backward hands the cotangents to the recorded rows; its
    sum, mean and std keep their own backward), and ``differ`` counts the
    entries where the CPU's own were others (leaky ReLU's under "relu")."""

    def __init__(self):
        self.sides = []
        self.differ = {"relu": 0, "min/max": 0}

    @contextlib.contextmanager
    def _patched(self, relu, extrema, leaky, stats):
        import torch
        from torch.nn import functional

        from hydragnn_tpu_torch.ops import csr_segment

        originals = (torch.relu, csr_segment.segment_extrema, functional.leaky_relu,
                     csr_segment.csr_segment_stats)
        torch.relu = lambda x: relu(originals[0], x)
        csr_segment.segment_extrema = lambda data, ids, n: extrema(originals[1], data, ids, n)
        functional.leaky_relu = lambda x, slope=0.01: leaky(originals[2], x, slope)

        def fused(data, ids, n, mask=None, eps=1e-5, want_std=True, want_extrema=True, *,
                  row_ptr):
            out = originals[3](data, ids, n, mask, eps, want_std, want_extrema, row_ptr=row_ptr)
            if not want_extrema:
                return out
            return out[:4] + stats(data, masked_ids(ids, mask), n, out[4], out[5])

        csr_segment.csr_segment_stats = fused
        try:
            yield self
        finally:
            (torch.relu, csr_segment.segment_extrema, functional.leaky_relu,
             csr_segment.csr_segment_stats) = originals

    def record(self):
        def relu(original, x):
            self.sides.append((x.detach() > 0).cpu())
            return original(x)

        def extrema(original, data, ids, n):
            mn, mx = original(data, ids, n)
            sels = extrema_selections(data.detach(), ids, mn.detach(), mx.detach())
            self.sides.append(tuple(s.cpu() for s in sels))
            return mn, mx

        def leaky(original, x, slope):
            self.sides.append((x.detach() > 0).cpu())
            return original(x, slope)

        def stats(data, ids, n, mn, mx):
            return extrema(lambda *_: (mn, mx), data, ids, n)

        return self._patched(relu, extrema, leaky, stats)

    def replay(self):
        replayed_extrema, replayed_relu, replayed_leaky = _replayed_functions()
        given = iter(self.sides)

        def relu(original, x):
            active = next(given).to(x.device)
            self.differ["relu"] += int(((x.detach() > 0) != active).sum())
            return replayed_relu.apply(x, active)

        def extrema(original, data, ids, n):
            sel_min, sel_max = (s.to(data.device) for s in next(given))
            mn, mx = replayed_extrema.apply(data, ids, n, sel_min, sel_max, original)
            own = extrema_selections(data.detach(), ids, mn.detach(), mx.detach())
            self.differ["min/max"] += int((own[0] != sel_min).sum() + (own[1] != sel_max).sum())
            return mn, mx

        def leaky(original, x, slope):
            active = next(given).to(x.device)
            self.differ["relu"] += int(((x.detach() > 0) != active).sum())
            return replayed_leaky.apply(x, active, slope)

        def stats(data, ids, n, mn, mx):
            # The values K5 gave; their cotangents go to the recorded rows.
            values = (mn.detach().clone(), mx.detach().clone())
            return extrema(lambda *_: values, data, ids, n)

        return self._patched(relu, extrema, leaky, stats)


def time_ms(fn, flush, reps=30, warmup=5):
    """Median ms of ``fn()`` by CUDA events, with L2 flushed (a 256 MiB
    write) before each launch, as after the model's preceding layers."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _group(name):
    if "csr_lanes_sum_kernel" in name:
        return "CSR segment sum (K1)"
    if "csr_stats_kernel" in name:
        return "CSR stats (K5)"
    if "csr_sum_count_kernel" in name or "long_run_partials_kernel" in name:
        return "segment run walk (K2's walk)"
    if any(k in name for k in ("count_kernel", "scan_kernel", "place_kernel",
                               "sort_small_kernel", "sort_medium_kernel", "order_large_kernel")):
        return "unsorted-id grouping (K2)"
    if "block_ranges_kernel" in name:
        return "block-skip ranges (K4 pass 1)"
    if "tile_walk_kernel" in name:
        return "block-skip walk (K4 pass 2)"
    if "multi_tensor_apply" in name:
        return "optimizer (foreach)"
    if "gemm" in name or "sm90" in name or "cutlass" in name or "matmul" in name:
        return "matmul"
    if "scatter" in name or "index" in name or "gather" in name:
        return "index/scatter"
    if "Memcpy" in name or "Memset" in name:
        return "copies/sets"
    return "other elementwise"


def aten_calls(run, name):
    """How many times one ``run()`` calls the PyTorch operator ``name``
    (``torch.profiler``, host side)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return sum(1 for evt in prof.events() if evt.name == name)


SENTINEL_CYCLES = 2000  # torch.cuda._sleep's spin: a marker kernel of ~1 us


_SENTINEL = {}


def _sentinel_name():
    """The device event name of the marker kernel ``torch.cuda._sleep``,
    read once from a window of three of them (the profiler may lose a
    window's events: up to four windows are taken)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if "name" not in _SENTINEL:
        for _ in range(4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    torch.cuda._sleep(SENTINEL_CYCLES)
                torch.cuda.synchronize()
            names = {evt.name for evt in prof.events() if evt.device_type == DeviceType.CUDA}
            if names:
                break
        if len(names) != 1:
            raise AssertionError(f"profiler: the marker kernel showed as {sorted(names)}")
        _SENTINEL["name"] = names.pop()
    return _SENTINEL["name"]


def _device_window(run, reps, sentinel):
    """One profiled window of ``reps`` calls of ``run``, opened and closed
    by a marker kernel outside the timed span: (the device events of the
    calls as (name, start, end), the wall time of the calls in us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
    spans = [(evt.name, evt.time_range.start, evt.time_range.end) for evt in prof.events()
             if evt.device_type == DeviceType.CUDA and evt.name != sentinel
             and evt.time_range.end > evt.time_range.start]
    return spans, wall_us


def profile_device(run, reps=10, per_call=None):
    """(a summary, device busy ms per call) of ``run``: device time per call
    by kernel group, device events per call and the device's idle share of
    the window, from ``torch.profiler``. Only the device's own events
    (kernels, copies, sets) are counted, each once: an operator's CPU-side
    row also carries its kernels' time. Each window opens and closes with a
    marker kernel, so an event the profiler loses at a window's edge is a
    marker. One call's device events are ``per_call`` where given, else the
    most that three windows of one call recorded (up to six where all
    recorded none); a window of ``reps`` calls that recorded another count
    is taken again, up to four times, and the summary says how many events
    the kept window dropped (then the busy time per call is that of the
    events recorded, busy x per_call / events). Raises if the device's busy
    time exceeds the wall time that encloses it; ("not measured", None)
    where the windows recorded no event."""
    import torch

    sentinel = _sentinel_name()
    run()
    torch.cuda.synchronize()
    if per_call is None:
        counts = []
        while len(counts) < 3 or (not max(counts) and len(counts) < 6):
            counts.append(len(_device_window(run, 1, sentinel)[0]))
        per_call = max(counts)
        if not per_call:
            return "not measured (the profiler recorded no device event of one call)", None
    want = per_call * reps
    windows = []
    for _ in range(4):
        windows.append(_device_window(run, reps, sentinel))
        if len(windows[-1][0]) == want:
            break
    spans, wall_us = min(windows, key=lambda w: abs(len(w[0]) - want))
    if not spans:
        return f"not measured (the profiler recorded no device event in {reps} calls)", None
    groups = {}
    for name, start, end in spans:
        group = _group(name)
        groups[group] = groups.get(group, 0.0) + (end - start)
    busy_us, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda sp: sp[1]):  # union of busy intervals
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    if busy_us > wall_us:
        raise AssertionError(f"profiler: device busy {busy_us:.1f} us > wall {wall_us:.1f} us")
    device_us = sum(groups.values())
    calls = len(spans) / per_call
    parts = ", ".join(
        f"{k} {v / calls / 1e3:.4f} ms ({100 * v / device_us:.1f}%)"
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])
    )
    text = (f"device busy {busy_us / calls / 1e3:.4f} ms/call of {wall_us / reps / 1e3:.4f} ms "
            f"wall, idle share {1.0 - busy_us / wall_us:.4f}; {len(spans) / reps:g} device "
            f"events/call of {per_call} ({want - len(spans)} of {want} dropped, "
            f"{len(windows) - 1} windows retaken); {parts}")
    return text, busy_us / calls / 1e3


def check_unsorted_kernel(dev, gen, host256, host512):
    """Phase 2b: the unsorted-id kernel against its plain version at the
    main path's shapes without CSR pointers and at edge cases. Counts must
    be bit-equal, two launches bit-identical, and every sum within the f32
    rounding bound 1e-5 x that element's sum of |x|. Returns the largest
    error at F <= 64 and at F > 64, and the main-path cases for timing."""
    import torch

    from hydragnn_tpu_torch.ops import segment_sum_count as ssc

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def masked(ids, mask):
        ids = torch.from_numpy(ids).to(dev)
        return torch.where(torch.from_numpy(mask).to(dev), ids, torch.full_like(ids, -1)).contiguous()

    n256, e256, g256p = host256.num_nodes_pad, host256.num_edges_pad, host256.num_graphs_pad
    n512, e512 = host512.num_nodes_pad, host512.num_edges_pad
    e_ids = masked(host256.receivers, host256.edge_mask)
    r_ids = masked(host256.node_graph, host256.node_mask)
    w_ids = masked(host512.receivers, host512.edge_mask)
    perm = torch.randperm(e256, device=dev, generator=gen)
    hub = torch.cat([torch.full((20000,), 5, device=dev, dtype=torch.int32),
                     torch.randint(0, 100, (3000,), device=dev, generator=gen, dtype=torch.int32)])
    hub = hub[torch.randperm(hub.shape[0], device=dev, generator=gen)].contiguous()
    sparse = torch.randint(0, 4000, (30000,), device=dev, generator=gen, dtype=torch.int32)
    unaligned = torch.empty(e256 * 64 + 1, device=dev)[1:].view(e256, 64)  # 4-byte offset
    unaligned.copy_(randn(e256, 64))
    f64 = randn(e256, 64)
    timed = [
        ("no CSR F=64, 256 graphs", f64, e_ids, n256),
        ("no CSR F=1, 256 graphs", randn(e256, 1), e_ids, n256),
        ("no CSR F=256, 512 graphs", randn(e512, 256), w_ids, n512),
    ]
    cases = timed + [
        ("readout no CSR F=64 (257 graphs)", randn(n256, 64), r_ids, g256p),
        ("randomly permuted ids F=64", f64[perm].contiguous(), e_ids[perm].contiguous(), n256),
        ("20000-edge hub F=64", randn(hub.shape[0], 64), hub, 100),
        ("half the segments empty F=64", randn(30000, 64), sparse, 8192),
        ("every row masked F=64", randn(e256, 64), torch.full_like(e_ids, -1), n256),
        ("F=33", randn(e256, 33), e_ids, n256),
        ("F=64 unaligned (scalar loads)", unaligned, e_ids, n256),
        ("hub F=256", randn(hub.shape[0], 256), hub, 100),
    ]
    errs = {"k2": 0.0, "k3": 0.0}
    for name, data, ids, n in cases:
        want_s, want_c = ssc.segment_sum_count_plain(data, ids, n)
        bound = ssc.segment_sum_count_plain(data.abs(), ids, n)[0]
        got_s, got_c = ssc.segment_sum_count_forward(data, ids, n)
        again_s, again_c = ssc.segment_sum_count_forward(data, ids, n)
        torch.cuda.synchronize()
        diff = (got_s - want_s).abs()
        if not bool((diff <= 1e-5 * bound).all()):
            worst = float((diff - 1e-5 * bound).max())
            raise AssertionError(f"{name}: sums beyond 1e-5 x sum|x| (by {worst})")
        if not torch.equal(got_c, want_c):
            raise AssertionError(f"{name}: counts differ")
        if not (torch.equal(got_s, again_s) and torch.equal(got_c, again_c)):
            raise AssertionError(f"{name}: two launches differ (not deterministic)")
        err = float(diff.max()) if diff.numel() else 0.0
        key = "k3" if data.shape[1] > ssc.WIDE_F else "k2"
        errs[key] = max(errs[key], err)
        print(f"phase 2b {name}: N={n} E={data.shape[0]} kept={int(want_c.sum())} "
              f"max abs err {err:.3e} (each <= 1e-5 x its sum|x|), counts equal, "
              f"bit-reproducible")
    return errs, timed


def step_card_vs_cpu(model, cpu_model, host, batch, names, label, per_forward):
    """One train step from ``model``'s weights on the card (K1 and K5
    launched ``per_forward`` times, nothing else) and on the CPU, the CPU's
    backward on the card's side of every kink; raises unless the losses
    agree within rtol 1e-5 and the gradient gap (:func:`grad_gap`) is <= 1.
    The same step also runs on the CPU in f64 (same kink sides). A tensor
    on which the CPU's own f32 gradient misses that f64 gradient by more
    than ``F32_LIMITED_SHARE`` of the tolerance (a sum whose terms cancel:
    GAT's ``lin_src.bias``, whose per-channel constant the batch norm
    removes from ~4700 node terms; GIN's ``eps``) is held to the f64
    gradient within the tolerance plus its f32 summation bound
    (:func:`f32_bounds`), where one is derived; every other tensor to the
    CPU's f32 gradient within the tolerance. Returns (kinks, card loss, card
    gradients, CPU gradients, gap, where, the rounding-level tensors, the
    gap on the CPU's own sides)."""
    from hydragnn_tpu_torch.graphs import GraphBatch
    from hydragnn_tpu_torch.train import loss_and_grads

    kinks = Kinks()
    with kinks.record():
        (loss, _, grads), _ = counted(lambda: loss_and_grads(copy.deepcopy(model), batch),
                                      label, **per_forward)
    cpu_batch = GraphBatch.from_numpy(host, "cpu")
    cpu_loss, _, raw_grads = loss_and_grads(copy.deepcopy(cpu_model), cpu_batch)
    with kinks.replay():
        _, _, cpu_grads = loss_and_grads(copy.deepcopy(cpu_model), cpu_batch)
    truth_kinks = Kinks()
    truth_kinks.sides = kinks.sides
    truth_model = copy.deepcopy(cpu_model).double()
    with truth_kinks.replay():
        (_, _, truth), bounds = f32_bounds(
            truth_model, lambda: loss_and_grads(truth_model, as_double(cpu_batch)))
    cpu_miss, _ = tensor_gaps(cpu_grads, truth, names)
    limited = {n: bounds[n] for n, miss in cpu_miss if miss > F32_LIMITED_SHARE and n in bounds}
    if not abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss)):
        raise AssertionError(f"{label}: loss card {float(loss)} vs CPU {float(cpu_loss)}")
    gaps, noise = tensor_gaps(grads, cpu_grads, names)
    held, _ = tensor_gaps(grads, truth, names, limited)
    gaps = [h if n in limited else (n, g) for (n, g), h in zip(gaps, held)]
    where, gap = max(reversed(gaps), key=lambda g: g[1])
    raw, raw_where, _ = grad_gap(grads, raw_grads, names)
    # Each bound as a multiple of the 1e-5 max|g| term it is added to, and
    # the card's gap to the f64 step there without it.
    scale = {n: float(b.max()) / (1e-5 * float(g.abs().max()))
             for n, b, g in ((n, limited[n], g) for n, g in zip(names, truth) if n in limited)}
    bare = {n: round(g, 4) for n, g in tensor_gaps(grads, truth, names)[0] if n in limited}
    print(f"{label}: loss {float(loss):.7f} / {float(cpu_loss):.7f}; gradient gap {gap:.4f} "
          f"at {where} on the card's side of every kink (the CPU's own side differed at "
          f"{kinks.differ['relu']} ReLU and {kinks.differ['min/max']} min/max entries; gap on "
          f"its own sides {raw:.4f} at {raw_where}); f32-limited, held to the f64 step within "
          f"the tolerance + ⌈log2 n⌉ 2^-24 Σ|terms| (bound / 1e-5 max|g|): "
          f"{ {k: round(v, 3) for k, v in scale.items()} }, their gap to it without the bound "
          f"{bare}; f32-limited without a bound "
          f"(held to the CPU unwidened): "
          f"{[n for n, miss in cpu_miss if miss > F32_LIMITED_SHARE and n not in bounds]}")
    if gap > 1.0:
        raise AssertionError(f"{label}: gradients card vs CPU gap {gap:.3f} > 1 at {where}")
    return kinks, loss, grads, cpu_grads, gap, where, noise, raw


def check_skip_kernel(dev, gen, host256, host512):
    """Phase 2c: the block-skip kernel K4 against its plain version, and
    against K2/K3, on the same inputs: the reference test's id patterns,
    the flagship's CSR-less shapes (masked receivers at F=1, 6, 64, 256 and
    384; the receivers of messages that pass no mask, whose padding edges
    all name the padding node, at F=1 and 384) and edge cases. Counts must
    be bit-equal, two launches bit-identical, and every sum within 1e-5 x
    that element's sum of |x| of both. Returns the largest error and the
    cases that phase 6 times."""
    import torch

    from hydragnn_tpu_torch.ops import segment_sum_count as ssc

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def masked(ids, mask):
        ids = torch.from_numpy(ids).to(dev)
        return torch.where(torch.from_numpy(mask).to(dev), ids, torch.full_like(ids, -1)).contiguous()

    n256, e256 = host256.num_nodes_pad, host256.num_edges_pad
    n512, e512 = host512.num_nodes_pad, host512.num_edges_pad
    e_ids = masked(host256.receivers, host256.edge_mask)
    raw_ids = torch.from_numpy(host256.receivers).to(dev).contiguous()
    w_ids = masked(host512.receivers, host512.edge_mask)
    rng = np.random.default_rng(17)
    contiguous = np.sort(rng.integers(0, 300, 1400)).astype(np.int32)
    scattered = rng.integers(0, 300, 1400).astype(np.int32)
    keep = rng.random(1400) > 0.2
    hub = torch.cat([torch.full((20000,), 5, device=dev, dtype=torch.int32),
                     torch.randint(0, 100, (3000,), device=dev, generator=gen, dtype=torch.int32)])
    hub = hub[torch.randperm(hub.shape[0], device=dev, generator=gen)].contiguous()
    sparse = torch.sort(torch.randint(0, 4000, (30000,), device=dev, generator=gen,
                                      dtype=torch.int32)).values.contiguous()
    unaligned = torch.empty(e256 * 64 + 1, device=dev)[1:].view(e256, 64)  # 4-byte offset
    unaligned.copy_(randn(e256, 64))
    timed = [
        ("no CSR F=64, masked receivers, 256 graphs", randn(e256, 64), e_ids, n256),
        ("no CSR F=1, masked receivers, 256 graphs", randn(e256, 1), e_ids, n256),
        ("no CSR F=384 (GAT messages), unmasked receivers, 256 graphs", randn(e256, 384),
         raw_ids, n256),
        ("no CSR F=1 (CGCNN), unmasked receivers, 256 graphs", randn(e256, 1), raw_ids, n256),
    ]
    cases = timed + [
        ("reference contiguous ids 1400x300x10", randn(1400, 10),
         torch.from_numpy(contiguous).to(dev), 300),
        ("reference scattered ids 1400x300x10", randn(1400, 10),
         torch.from_numpy(scattered).to(dev), 300),
        ("reference masked ids 1400x300x10", randn(1400, 10),
         masked(contiguous, keep), 300),
        ("no CSR F=6 (GAT denominator), masked receivers", randn(e256, 6), e_ids, n256),
        ("no CSR F=384, masked receivers", randn(e256, 384), e_ids, n256),
        ("no CSR F=256, 512 graphs", randn(e512, 256), w_ids, n512),
        ("20000-edge hub F=64 (scattered)", randn(hub.shape[0], 64), hub, 100),
        ("half the segments empty F=64", randn(30000, 64), sparse, 8192),
        ("every row masked F=64", randn(e256, 64), torch.full_like(e_ids, -1), n256),
        ("F=64 unaligned (scalar loads)", unaligned, e_ids, n256),
    ]
    worst = 0.0
    for name, data, ids, n in cases:
        want_s, want_c = ssc.segment_sum_count_skip_plain(data, ids, n)
        bound = ssc.segment_sum_count_plain(data.abs(), ids, n)[0]
        got_s, got_c = ssc.segment_sum_count_skip_forward(data, ids, n)
        again_s, again_c = ssc.segment_sum_count_skip_forward(data, ids, n)
        k2_s, k2_c = ssc.segment_sum_count_forward(data, ids, n)
        torch.cuda.synchronize()
        for what, ref in (("its plain version", want_s), ("K2/K3", k2_s)):
            diff = (got_s - ref).abs()
            if not bool((diff <= 1e-5 * bound).all()):
                excess = float((diff - 1e-5 * bound).max())
                raise AssertionError(f"phase 2c {name}: sums vs {what} beyond 1e-5 x sum|x| "
                                     f"(by {excess})")
        if not (torch.equal(got_c, want_c) and torch.equal(got_c, k2_c)):
            raise AssertionError(f"phase 2c {name}: counts differ")
        if not (torch.equal(got_s, again_s) and torch.equal(got_c, again_c)):
            raise AssertionError(f"phase 2c {name}: two launches differ (not deterministic)")
        err = float((got_s - want_s).abs().max()) if got_s.numel() else 0.0
        k2_err = float((got_s - k2_s).abs().max()) if got_s.numel() else 0.0
        worst = max(worst, err)
        print(f"phase 2c K4 {name}: N={n} E={data.shape[0]} kept={int(want_c.sum())} max abs "
              f"err {err:.3e} vs plain, {k2_err:.3e} vs K2/K3 (each <= 1e-5 x its sum|x|), "
              f"counts equal, bit-reproducible")
    return worst, timed


def parent_bundle(data, mask, ids, row_ptr, n):
    """The parent's PNA bundle on the CSR route, in the same calls: masked
    rows zeroed, a K1 (sum, count) pass, the mean, the centred squares, a
    second K1 pass, the std; min and max by ``scatter_reduce`` over the kept
    rows (``ops/segment.py``). Phase 6 times it beside K5."""
    import torch

    from hydragnn_tpu_torch.ops import csr_segment
    from hydragnn_tpu_torch.ops import segment as seg

    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    zeroed = torch.where(mask[:, None], data, zero)
    total, count = csr_segment.csr_segment_sum_count_forward(zeroed, row_ptr, n)
    safe = count.clamp_min(1.0)[:, None]
    mean = total / safe
    idx = ids.long().clamp(0, n - 1)
    centered = torch.where((ids >= 0)[:, None], zeroed - mean.index_select(0, idx), zero)
    sumsq, _ = csr_segment.csr_segment_sum_count_forward(centered.square().contiguous(), row_ptr, n)
    std = torch.sqrt(sumsq / safe + 1e-5)
    kept = masked_ids(ids, mask)
    valid = kept >= 0
    safe_ids = torch.where(valid, kept, torch.zeros_like(kept))
    mn = seg.segment_min(data, safe_ids, n, mask=valid)
    mx = seg.segment_max(data, safe_ids, n, mask=valid)
    return total, mean, std, count, mn, mx


def check_stats_kernel(dev, gen, host256, host512):
    """Phase 2d: K5 against its plain version on the card, at the flagship's
    PNA shapes (the raw messages of layer 0 at F=1, of layers 1-2 at F=64,
    of hidden 256 at F=256, the edge mask of collation) and at phase 2c's
    edge cases: a 20000-edge hub, every row masked, half the segments empty,
    an unaligned pointer, and without std or extrema. Counts, min and max
    must be bit-equal, mean and std within KERNEL_CERT_GATE.fwd of the f64
    plain version, and sums within the larger of that and 1e-5 x their sum
    of |x| (phase 2's bound on a 20000-term run), two launches
    bit-identical. Returns the largest
    error against f64 and the flagship cases for timing."""
    import torch

    from hydragnn_tpu_torch.graphs.csr import build_row_ptr
    from hydragnn_tpu_torch.ops import csr_segment

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def ptr(lens):
        return torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32,
                            device=dev)

    n256, e256 = host256.num_nodes_pad, host256.num_edges_pad
    n512, e512 = host512.num_nodes_pad, host512.num_edges_pad
    rp256 = torch.from_numpy(host256.row_ptr).to(dev)
    rp512 = torch.from_numpy(host512.row_ptr).to(dev)
    ids256 = torch.from_numpy(host256.receivers).to(dev)
    ids512 = torch.from_numpy(host512.receivers).to(dev)
    m256 = torch.from_numpy(host256.edge_mask).to(dev)
    m512 = torch.from_numpy(host512.edge_mask).to(dev)
    hub_lens = [3] * 40 + [20000] + [5] * 40
    hub_ptr = ptr(hub_lens)
    rng = np.random.default_rng(29)
    sparse = np.sort(rng.integers(0, 4000, 30000)).astype(np.int32)
    sparse_ptr = torch.from_numpy(build_row_ptr(sparse, 8192)).to(dev)
    unaligned = torch.empty(e256 * 64 + 1, device=dev)[1:].view(e256, 64)  # 4-byte offset
    unaligned.copy_(randn(e256, 64))

    def keep(e, share=0.25):
        return torch.from_numpy(rng.random(e) > share).to(dev)

    timed = [
        ("layer 0 F=1, 256 graphs", randn(e256, 1), m256, ids256, rp256, n256),
        ("layers 1-2 F=64, 256 graphs", randn(e256, 64), m256, ids256, rp256, n256),
        ("hidden 256 F=256, 512 graphs", randn(e512, 256), m512, ids512, rp512, n512),
    ]
    cases = [(name, data, mask, p, n, {}) for name, data, mask, _, p, n in timed] + [
        ("20000-edge hub F=64", randn(sum(hub_lens), 64), keep(sum(hub_lens)), hub_ptr, 81, {}),
        ("20000-edge hub F=1", randn(sum(hub_lens), 1), keep(sum(hub_lens)), hub_ptr, 81, {}),
        ("20000-edge hub F=256", randn(sum(hub_lens), 256), keep(sum(hub_lens)), hub_ptr, 81,
         {}),
        ("every row masked F=64", randn(e256, 64), torch.zeros_like(m256), rp256, n256, {}),
        ("half the segments empty F=64", randn(30000, 64), keep(30000), sparse_ptr, 8192, {}),
        ("F=64 unaligned (scalar loads)", unaligned, m256, rp256, n256, {}),
        ("F=33", randn(e256, 33), m256, rp256, n256, {}),
        ("F=64 no mask, no std, no extrema", randn(e256, 64), None, rp256, n256,
         dict(want_std=False, want_extrema=False)),
    ]
    worst = 0.0
    for name, data, mask, p, n, kw in cases:
        want = csr_segment.csr_segment_stats_plain(data, mask, p, n, **kw)
        truth = csr_segment.csr_segment_stats_plain(data.double(), mask, p, n, **kw)
        got = csr_segment.csr_segment_stats_forward(data, mask, p, n, **kw)
        again = csr_segment.csr_segment_stats_forward(data, mask, p, n, **kw)
        torch.cuda.synchronize()
        for what, a, b in zip(("count", "min", "max"), got[3:], want[3:]):
            if not (a is None and b is None) and not torch.equal(a, b):
                raise AssertionError(f"phase 2d {name}: {what} not bit-equal to the plain version")
        errs = [float((a.double() - b).abs().max()) if a.numel() else 0.0
                for a, b in zip(got[:3], truth[:3])]
        # A raw sum of a long run may also take the f32 rounding bound of
        # phase 2: 1e-5 x its sum of |x|.
        sum_bound = torch.clamp_min(1e-5 * csr_segment.csr_segment_sum_count_plain(
            data.abs().double(), p, n)[0], KERNEL_CERT_FWD)
        if not (bool(((got[0].double() - truth[0]).abs() <= sum_bound).all())
                and max(errs[1:]) <= KERNEL_CERT_FWD):
            raise AssertionError(f"phase 2d {name}: sum/mean/std errors {errs} vs f64 beyond "
                                 f"max({KERNEL_CERT_FWD}, 1e-5 x sum|x|) / {KERNEL_CERT_FWD}")
        if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"phase 2d {name}: two launches differ (not deterministic)")
        worst = max(worst, *errs)
        print(f"phase 2d K5 {name}: N={n} E={data.shape[0]} kept="
              f"{data.shape[0] if mask is None else int(mask.sum())}; max abs err vs f64 sum "
              f"{errs[0]:.3e} (<= max({KERNEL_CERT_FWD}, 1e-5 x sum|x|)), mean {errs[1]:.3e}, "
              f"std {errs[2]:.3e} (<= {KERNEL_CERT_FWD}); "
              f"counts{', min, max' if got[4] is not None else ''} bit-equal, bit-reproducible")
    return worst, timed


def families_phase(dev, graphs, host):
    """Phase 7: the five other conv families at the flagship's widths
    (hidden 64, 3 layers, the flagship heads, ``edge_dim=1``,
    ``max_neighbours=20``), random weights from seed 0. Returns the K4
    launches of their CSR-less forwards under the switch."""
    import torch

    from hydragnn_tpu_torch.graphs import GraphBatch
    from hydragnn_tpu_torch.preprocess import GraphDataLoader
    from hydragnn_tpu_torch.serve import InferenceEngine
    from hydragnn_tpu_torch.train import TrainingDriver, train_validate_test
    from hydragnn_tpu_torch.utils import select_optimizer

    rng = np.random.default_rng(3)
    sets = [make_graphs(k * BATCH_GRAPHS, rng) for k in (FAMILY_TRAIN_BATCHES, 1, 1)]
    kw = dict(head_types=TYPES, head_dims=DIMS, edge_dim=1, seed=0)
    top = (host.num_nodes_pad, host.num_edges_pad)
    batch = GraphBatch.from_numpy(host, dev)
    k4_total = 0
    for family in FAMILIES:
        t0 = time.perf_counter()
        per_forward = launches_per_forward(family)
        # GAT's attention dropout at 0 for the comparisons; the defaults
        # (0.25) for the training run below.
        model = build_model(64, "cuda", family, dropout=0.0)
        engine = InferenceEngine(model, device="cuda", max_batch_graphs=256, max_delay_ms=20.0,
                                 queue_limit=512, bucket_ladder=[top])
        try:
            res, served, batches = serve_with_counts(
                engine, lambda eng: eng.predict(unlabeled(graphs)), per_forward)
            launches = served["k1"]
        finally:
            engine.close()
        check_outputs(res, graphs, f"phase 7 {family} serve")
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu_engine = InferenceEngine(cpu_model, device="cpu", max_batch_graphs=256,
                                     max_delay_ms=20.0, queue_limit=512, bucket_ladder=[top])
        try:
            cpu_res = cpu_engine.predict(unlabeled(graphs))
        finally:
            cpu_engine.close()
        gap = max_rel_gap(res, cpu_res)
        if gap > 1.0:
            raise AssertionError(f"phase 7 {family}: card vs CPU outputs gap {gap:.3f} > 1")

        with torch.inference_mode():
            csr_out = model(batch)
            with skip_switch():
                bare_out, bare = counted(lambda: model(without_pointers(batch)),
                                         f"phase 7 {family} forward without CSR pointers, skip",
                                         k4=bare_launches(family))
        bgap = max_rel_gap([real_rows(bare_out, host)], [real_rows(csr_out, host)])
        if bgap > 1.0:
            raise AssertionError(f"phase 7 {family}: K4 forward vs CSR forward gap {bgap:.3f} > 1")
        k4_total += bare["k4"]

        names = [n for n, _ in model.named_parameters()]
        _, _, grads, _, sgap, swhere, noise, raw = step_card_vs_cpu(
            model, cpu_model, host, batch, names, f"phase 7 {family} train step card vs CPU",
            per_forward)

        trained = build_model(64, "cuda", family)
        loaders = [GraphDataLoader(sets[0], BATCH_GRAPHS, shuffle=True, **kw)] + [
            GraphDataLoader(g, BATCH_GRAPHS, shuffle=False, **kw) for g in sets[1:]]
        driver = TrainingDriver(trained, select_optimizer(trained, "adamw", 1e-3), device="cuda")
        forwards = EPOCHS * (FAMILY_TRAIN_BATCHES + 2)
        hist, tcounts = counted(lambda: train_validate_test(driver, *loaders, EPOCHS),
                                f"phase 7 {family} training", k1=per_forward["k1"] * forwards)
        losses = hist["total_loss_train"]
        if not (np.isfinite(losses).all() and np.isfinite(hist["total_loss_val"]).all()):
            raise AssertionError(f"phase 7 {family} training: non-finite history {hist}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"phase 7 {family} training: train loss did not fall: {losses}")
        print(f"phase 7 {family}: serve {batches} batch forward(s), {launches} K1 launches "
              f"({per_forward['k1']} per forward), card vs CPU gap {gap:.4f}; without CSR pointers "
              f"under the skip switch {bare['k4']} K4 launches, 0 K1, 0 K2/K3, vs the CSR "
              f"forward {bgap:.4f}; train step gradient gap {sgap:.4f} at {swhere} "
              f"({len(grads)} tensors, rounding-level: {noise}; on the CPU's own sides "
              f"{raw:.4f}); {EPOCHS} epochs x {FAMILY_TRAIN_BATCHES} train batches of "
              f"{BATCH_GRAPHS} (dropout {trained.dropout if family == 'GAT' else 'n/a'}): "
              f"{tcounts['k1']} K1 launches, train loss {[round(v, 6) for v in losses]}; "
              f"{time.perf_counter() - t0:.1f} s")
        del model, cpu_model, trained, driver
    return k4_total


def train_phase(dev):
    """Phase 5: the flagship model trained through the port's entry points
    on the card; returns what the later phases reuse."""
    import torch

    from hydragnn_tpu_torch.graphs import GraphBatch
    from hydragnn_tpu_torch.preprocess import GraphDataLoader
    from hydragnn_tpu_torch.train import TrainingDriver, loss_and_grads, train_validate_test
    from hydragnn_tpu_torch.utils import ReduceLROnPlateau, select_optimizer

    rng = np.random.default_rng(2)
    sets = [make_graphs(k * BATCH_GRAPHS, rng) for k in (TRAIN_BATCHES, EVAL_BATCHES, EVAL_BATCHES)]
    kw = dict(head_types=TYPES, head_dims=DIMS, edge_dim=1, seed=0)
    loaders = [GraphDataLoader(sets[0], BATCH_GRAPHS, shuffle=True, **kw)] + [
        GraphDataLoader(g, BATCH_GRAPHS, shuffle=False, **kw) for g in sets[1:]]
    model = build_model(64, "cuda")
    opt = select_optimizer(model, "adamw", 1e-3)
    driver = TrainingDriver(model, opt, device="cuda")
    forwards = EPOCHS * (TRAIN_BATCHES + 2 * EVAL_BATCHES)
    t0 = time.perf_counter()
    hist, counts = counted(
        lambda: train_validate_test(driver, *loaders, EPOCHS, scheduler=ReduceLROnPlateau()),
        "training", k1=LAUNCHES_PER_FORWARD["k1"] * forwards,
        k5=LAUNCHES_PER_FORWARD["k5"] * forwards)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    values = np.asarray([hist[k] for k in ("total_loss_train", "total_loss_val", "total_loss_test")])
    tasks = np.asarray([hist[k] for k in ("task_loss_train", "task_loss_val", "task_loss_test")])
    if not (np.isfinite(values).all() and np.isfinite(tasks).all()):
        raise AssertionError(f"training: non-finite history {hist}")
    train_loss = hist["total_loss_train"]
    if not train_loss[-1] < train_loss[0]:
        raise AssertionError(f"training: train loss did not fall: {train_loss}")
    print(f"phase 5 training: {EPOCHS} epochs x ({TRAIN_BATCHES} train + {EVAL_BATCHES} val + "
          f"{EVAL_BATCHES} test) batches of {BATCH_GRAPHS} graphs, pads {loaders[0].pad_sizes}: "
          f"{counts['k1']} K1 + {counts['k5']} K5 launches = {LAUNCHES_PER_FORWARD} x "
          f"{forwards} forwards (none from the backward), 0 unsorted-id; train loss {[round(v, 6) for v in train_loss]}, "
          f"val {[round(v, 6) for v in hist['total_loss_val']]}, test "
          f"{[round(v, 6) for v in hist['total_loss_test']]}; {wall:.2f} s wall "
          f"({EPOCHS * TRAIN_BATCHES * BATCH_GRAPHS / wall:.1f} train graphs/s with the "
          f"evaluations and host collation inside)")
    main_counts = counts

    # One step from the trained weights on each train batch of epoch 0, on
    # the card and on the CPU; the CPU step takes the card's side of every
    # kink (Kinks), and the gap without that is printed beside it.
    loaders[0].set_epoch(0)
    names = [n for n, _ in model.named_parameters()]
    cpu_model = copy.deepcopy(model).to("cpu")
    worst, worst_where, worst_raw, differ = 0.0, None, 0.0, {"relu": 0, "min/max": 0}
    for b, host in enumerate(loaders[0]):
        step_batch = GraphBatch.from_numpy(host, dev)
        kinks, step_loss, step_grads, cpu_grads, gap, where, noise, raw = step_card_vs_cpu(
            model, cpu_model, host, step_batch, names, f"phase 5 train step card vs CPU, batch {b}",
            LAUNCHES_PER_FORWARD)
        if b == 0:
            batch, loss, grads, sides = step_batch, step_loss, step_grads, kinks.sides
            ratios = [float(g.abs().max()) for g in cpu_grads]
            ratios = [r / max(ratios) for r in ratios]
        if gap >= worst:
            worst, worst_where = gap, where
        worst_raw = max(worst_raw, raw)
        differ = {k: differ[k] + v for k, v in kinks.differ.items()}
    print(f"phase 5 {TRAIN_BATCHES} train steps card vs CPU: losses within rtol 1e-5, "
          f"{len(grads)} gradients within rtol 1e-4 + atol 1e-5 x each tensor's max|g| (worst "
          f"{worst:.4f} of the tolerance, at {worst_where}); the CPU's own side of a kink "
          f"differed at {differ['relu']} ReLU and {differ['min/max']} min/max entries (worst "
          f"gap on its own sides {worst_raw:.4f}); held to the step's "
          f"max|g| as rounding-level (< {ROUNDING_LEVEL:g} x it; own max|g| / the step's): "
          f"{noise}; smallest other own max|g| / the step's: "
          f"{min(r for r in ratios if r >= ROUNDING_LEVEL):.1e}")
    bare_kinks = Kinks()
    bare_kinks.sides = sides
    with bare_kinks.replay():
        (bare_loss, _, bare_grads), bare_counts = counted(
            lambda: loss_and_grads(copy.deepcopy(model), without_pointers(batch)),
            "train step without CSR pointers", k2=BARE_PER_FORWARD)
    bgap, bwhere, bnoise = grad_gap(bare_grads, grads, names)
    if not abs(float(bare_loss) - float(loss)) <= 1e-5 * abs(float(loss)) or bgap > 1.0:
        raise AssertionError(f"train step without CSR: loss {float(bare_loss)} vs "
                             f"{float(loss)}, gradient gap {bgap:.3f} at {bwhere}")
    print(f"phase 5 one train step without CSR pointers: {bare_counts['k2']} unsorted-id launches, "
          f"0 K1; loss {float(bare_loss):.7f}, gradients vs the CSR step's worst {bgap:.4f} "
          f"of the tolerance, at {bwhere}, on the CSR step's side of every kink (its own "
          f"side differed at {bare_kinks.differ['relu']} ReLU and "
          f"{bare_kinks.differ['min/max']} min/max entries); rounding-level: {bnoise}")
    return model, opt, batch, main_counts, bare_counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script drives "
              "the port on a GPU and has no CPU mode", file=sys.stderr)
        return 2
    from hydragnn_tpu_torch.graphs import GraphBatch, collate_graphs, compute_pad_sizes
    from hydragnn_tpu_torch.models import multihead_rmse_loss
    from hydragnn_tpu_torch.ops import _build, csr_segment
    from hydragnn_tpu_torch.ops import segment_sum_count as ssc
    from hydragnn_tpu_torch.serve import InferenceEngine
    from hydragnn_tpu_torch.train import train_step
    from hydragnn_tpu_torch.utils import resolve_device, select_optimizer

    t_start = time.perf_counter()
    # Phases 3-5 drive the switch-off routes; phase 7 turns it on itself.
    os.environ.pop("HYDRAGNN_PALLAS_SKIP", None)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- phase 1: build, one nvcc per source, all at once
    t_build = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(_build.build, KERNELS))
    print(f"phase 1 build: {time.perf_counter() - t_build:.2f} s wall for {len(KERNELS)} sources")
    for name, (path, log, build_s) in zip(KERNELS, builds):
        print(f"phase 1 {name}: {build_s:.2f} s -> {path.name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(0)
    predict_sets = [make_graphs(256, rng) for _ in range(3)]
    lone = make_graphs(8, rng)
    wide_graphs = make_graphs(512, np.random.default_rng(1))
    g256 = predict_sets[0]
    top = compute_pad_sizes(g256, 256)[:2]
    low = compute_pad_sizes(lone, 8)[:2]
    host256 = collate_graphs(g256, TYPES, DIMS, num_nodes_pad=top[0], num_edges_pad=top[1],
                             num_graphs_pad=257, edge_dim=1)
    host512 = collate_graphs(wide_graphs, TYPES, DIMS, edge_dim=1)
    print(f"flagship batch: 256 graphs, N_pad={host256.num_nodes_pad} "
          f"E_pad={host256.num_edges_pad} real nodes={int(host256.node_mask.sum())} "
          f"real edges={int(host256.edge_mask.sum())}; wide batch: 512 graphs, "
          f"N_pad={host512.num_nodes_pad} E_pad={host512.num_edges_pad}")

    # ---- phase 2: kernels vs plain on the card
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    rp256 = torch.from_numpy(host256.row_ptr).to(dev)
    gp256 = torch.from_numpy(host256.graph_ptr).to(dev)
    rp512 = torch.from_numpy(host512.row_ptr).to(dev)
    gp512 = torch.from_numpy(host512.graph_ptr).to(dev)
    n256, e256, g256p = host256.num_nodes_pad, host256.num_edges_pad, host256.num_graphs_pad
    n512, e512, g512p = host512.num_nodes_pad, host512.num_edges_pad, host512.num_graphs_pad
    # The path zeroes masked rows before each call (padding edges, and
    # padding nodes for the readout), so their data here is zero too.
    emask256 = torch.from_numpy(host256.edge_mask).to(dev)[:, None]
    nmask256 = torch.from_numpy(host256.node_mask).to(dev)[:, None]
    emask512 = torch.from_numpy(host512.edge_mask).to(dev)[:, None]
    nmask512 = torch.from_numpy(host512.node_mask).to(dev)[:, None]
    unaligned = torch.empty(e256 * 64 + 1, device=dev)[1:].view(e256, 64)  # 4-byte offset
    unaligned.copy_(randn(e256, 64) * emask256)
    long_run = torch.tensor([0, 5, 5, 20005], dtype=torch.int32, device=dev)
    # Runs on both sides of the kernel's 128-edge chunk, one starting on a
    # chunk boundary, with row_ptr[0] > 0.
    lens = [128, 129, 0, 256, 257, 1, 300, 127, 1000, 385]
    edge_ptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]) + 3, dtype=torch.int32,
                            device=dev)
    e_edges = int(edge_ptr[-1]) + 10
    # (name, data, row_ptr, num_segments, tolerance scale): "sum" holds the
    # error to 1e-5 x max|sum|; "abs" to 1e-5 x the largest row's sum of
    # |x|, the f32 rounding bound of a 20000-term run.
    cases = [
        ("node pass F=64 (256 graphs)", randn(e256, 64) * emask256, rp256, n256, "sum"),
        ("node pass F=1 (layer 0)", randn(e256, 1) * emask256, rp256, n256, "sum"),
        ("readout F=64 (graph_ptr)", randn(n256, 64) * nmask256, gp256, g256p, "sum"),
        ("node pass F=256 (512 graphs)", randn(e512, 256) * emask512, rp512, n512, "sum"),
        ("readout F=256 (graph_ptr)", randn(n512, 256) * nmask512, gp512, g512p, "sum"),
        ("F=33", randn(e256, 33) * emask256, rp256, n256, "sum"),
        ("F=64 unaligned (scalar loads)", unaligned, rp256, n256, "sum"),
        ("all rows empty", randn(100, 8), torch.zeros(51, dtype=torch.int32, device=dev), 50, "sum"),
        ("3 segments < rows of a block", randn(10, 12),
         torch.tensor([0, 4, 4, 10], dtype=torch.int32, device=dev), 3, "sum"),
        ("one 20000-edge run, unmasked", randn(20005, 64), long_run, 3, "abs"),
        ("chunk-edge runs F=64", randn(e_edges, 64), edge_ptr, len(lens), "abs"),
        ("chunk-edge runs F=33", randn(e_edges, 33), edge_ptr, len(lens), "abs"),
        ("chunk-edge runs F=1", randn(e_edges, 1), edge_ptr, len(lens), "abs"),
    ]
    # Every lane-group width (lanes per sub-group 1, 2, 4, 8, 16, 32, and
    # column blocks past 64 groups) on runs around the piece sizes.
    lane_ptr = torch.tensor(np.concatenate([[0], np.cumsum(LANE_RUNS)]) + 3, dtype=torch.int32,
                            device=dev)
    for f in LANE_F:
        cases.append((f"lane groups F={f}", randn(int(lane_ptr[-1]) + 5, f), lane_ptr,
                      len(LANE_RUNS), "abs"))
    max_abs_err = 0.0
    for name, data, ptr, n, kind in cases:
        want_s, want_c = csr_segment.csr_segment_sum_count_plain(data, ptr, n)
        got_s, got_c = csr_segment.csr_segment_sum_count_forward(data, ptr, n)
        again_s, _ = csr_segment.csr_segment_sum_count_forward(data, ptr, n)
        torch.cuda.synchronize()
        err = float((got_s - want_s).abs().max()) if got_s.numel() else 0.0
        if kind == "sum":
            scale = float(want_s.abs().max()) if want_s.numel() else 0.0
        else:
            scale = float(csr_segment.csr_segment_sum_count_plain(data.abs(), ptr, n)[0].max())
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{name}: max abs err {err} > 1e-5 x {scale}")
        if not torch.equal(got_c, want_c):
            raise AssertionError(f"{name}: counts differ")
        if not torch.equal(got_s, again_s):
            raise AssertionError(f"{name}: two launches differ (not deterministic)")
        max_abs_err = max(max_abs_err, err)
        print(f"phase 2 {name}: N={n} E={data.shape[0]} max abs err {err:.3e} "
              f"(<= 1e-5 x {scale:.3e}, {'max|sum|' if kind == 'sum' else 'max row sum|x|'}), "
              f"counts equal, bit-reproducible")
    unsorted_errs, timed2 = check_unsorted_kernel(dev, gen, host256, host512)
    skip_err, timed_skip = check_skip_kernel(dev, gen, host256, host512)
    stats_err, timed_stats = check_stats_kernel(dev, gen, host256, host512)

    # ---- phase 3: serve the flagship model
    model = build_model(64, "cuda")
    engine = InferenceEngine(model, device="cuda", max_batch_graphs=256, max_delay_ms=20.0,
                             queue_limit=512, bucket_ladder=[low, top])
    try:
        def main_path(eng):
            results = [eng.predict(unlabeled(gs)) for gs in predict_sets]
            singles = []
            for s in unlabeled(lone):
                singles.append(eng.submit(s).result(60))
            return results, singles

        (results, singles), served, batches = serve_with_counts(engine, main_path)
        for gs, res in zip(predict_sets, results):
            check_outputs(res, gs, "serve predict")
        check_outputs(singles, lone, "serve submit")
        print(f"phase 3 serve: 3 x 256-graph predicts + 8 submits -> {batches} batch "
              f"forwards, {served['k1']} K1 + {served['k5']} K5 launches "
              f"({LAUNCHES_PER_FORWARD} per forward), ladder fallbacks {engine.ladder_fallbacks}")
        serve_k1, serve_k5 = served["k1"], served["k5"]

        cpu_model = copy.deepcopy(model).to("cpu")
        cpu_engine = InferenceEngine(cpu_model, device="cpu", max_batch_graphs=256,
                                     max_delay_ms=20.0, queue_limit=512, bucket_ladder=[low, top])
        try:
            cpu_res = cpu_engine.predict(unlabeled(g256))
        finally:
            cpu_engine.close()
        gap = max_rel_gap(results[0], cpu_res)
        if gap > 1.0:
            raise AssertionError(f"card vs CPU outputs beyond rtol={RTOL}, atol={ATOL} (gap {gap:.3f})")
        print(f"phase 3 card vs CPU (256 graphs): max |diff| / (atol + rtol|cpu|) = {gap:.4f} <= 1")

        batch = GraphBatch.from_numpy(host256, dev)
        cpu_batch = GraphBatch.from_numpy(host256, "cpu")
        with torch.inference_mode():
            loss, rmses = multihead_rmse_loss(model(batch), batch, TYPES, model.task_weights)
            cpu_loss, cpu_rmses = multihead_rmse_loss(cpu_model(cpu_batch), cpu_batch, TYPES,
                                                      cpu_model.task_weights)
        if not torch.allclose(rmses.cpu(), cpu_rmses, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"loss card {rmses.tolist()} vs CPU {cpu_rmses.tolist()}")
        print(f"phase 3 multihead_rmse_loss: card {float(loss):.6f} (per head "
              f"{[round(v, 6) for v in rmses.tolist()]}), CPU {float(cpu_loss):.6f}")

        with torch.inference_mode():
            csr_out = model(batch)
            scatters = aten_calls(lambda: model(batch), "aten::scatter_reduce")
            bare_out, bare = counted(lambda: model(without_pointers(batch)),
                                     "forward without CSR pointers", k2=BARE_PER_FORWARD)
        if scatters:
            raise AssertionError(f"the CSR forward called scatter_reduce {scatters} times")
        bgap = max_rel_gap([real_rows(bare_out, host256)], [real_rows(csr_out, host256)])
        if bgap > 1.0:
            raise AssertionError(f"forward without CSR vs CSR forward gap {bgap:.3f} > 1")
        print(f"phase 3 CSR forward: 0 scatter_reduce calls (torch.profiler); forward without "
              f"CSR pointers: {bare['k2']} unsorted-id launches, 0 K1, 0 K5; "
              f"outputs vs the CSR forward {bgap:.4f} of rtol={RTOL}, atol={ATOL}")
        unsorted_small = bare["k2"] - bare["wide"]

        # ---- phase 4: full width
        wide = build_model(256, "cuda")
        wide_top = compute_pad_sizes(wide_graphs, 512)[:2]
        wide_engine = InferenceEngine(wide, device="cuda", max_batch_graphs=512,
                                      max_delay_ms=50.0, queue_limit=512, bucket_ladder=[wide_top])
        try:
            wide_res, wcounted, wb = serve_with_counts(
                wide_engine, lambda eng: eng.predict(unlabeled(wide_graphs)))
        finally:
            wide_engine.close()
        check_outputs(wide_res, wide_graphs, "full width")
        wide_cpu = InferenceEngine(copy.deepcopy(wide).to("cpu"), device="cpu",
                                   max_batch_graphs=512, max_delay_ms=50.0, queue_limit=512,
                                   bucket_ladder=[wide_top])
        try:
            wide_cpu_res = wide_cpu.predict(unlabeled(wide_graphs))
        finally:
            wide_cpu.close()
        wgap = max_rel_gap(wide_res, wide_cpu_res)
        if wgap > 1.0:
            raise AssertionError(f"full width: card vs CPU gap {wgap:.3f} > 1")
        print(f"phase 4 full width (hidden 256, 512 graphs): {wb} batch forwards, "
              f"{wcounted['k1']} K1 + {wcounted['k5']} K5 launches, card vs CPU gap "
              f"{wgap:.4f} <= 1")
        wbatch = GraphBatch.from_numpy(host512, dev)
        # Layer 0 aggregates F=1 messages; layers 1-2 and the readout F=256.
        wide_passes = 2 * (LAYERS - 1) + 1
        with torch.inference_mode():
            w_csr = wide(wbatch)
            w_bare, wcounts = counted(lambda: wide(without_pointers(wbatch)),
                                      "full width without CSR pointers",
                                      k2=BARE_PER_FORWARD, wide=wide_passes)
        w_bgap = max_rel_gap([real_rows(w_bare, host512)], [real_rows(w_csr, host512)])
        if w_bgap > 1.0:
            raise AssertionError(f"full width without CSR vs CSR gap {w_bgap:.3f} > 1")
        print(f"phase 4 full width without CSR pointers: {wcounts['k2']} unsorted-id launches "
              f"({wcounts['wide']} at F=256), 0 K1; outputs vs the CSR forward {w_bgap:.4f}")
        unsorted_small += wcounts["k2"] - wcounts["wide"]
        unsorted_wide = wcounts["wide"]
        del wide, w_csr, w_bare

        # ---- phase 5: training
        tmodel, topt, tbatch, train_counts, step_counts = train_phase(dev)
        train_k1, train_k5 = train_counts["k1"], train_counts["k5"]
        unsorted_small += step_counts["k2"] - step_counts["wide"]

        # ---- phase 6: times
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
        records = []
        timed = [
            ("node pass F=64, 256 graphs", cases[0][1], rp256, n256),
            ("node pass F=1, 256 graphs", cases[1][1], rp256, n256),
            ("readout F=64, 256 graphs", cases[2][1], gp256, g256p),
            ("node pass F=256, 512 graphs", cases[3][1], rp512, n512),
            ("readout F=256, 512 graphs", cases[4][1], gp512, g512p),
        ]
        for name, data, ptr, n in timed:
            f = data.shape[1]
            ids = torch.repeat_interleave(torch.arange(n, device=dev), ptr.diff().long())
            walked = int(ptr[-1] - ptr[0])
            rows = data[int(ptr[0]): int(ptr[0]) + walked]
            offsets = (ptr - ptr[0]).long()
            calls = {
                "kernel": lambda: csr_segment.csr_segment_sum_count_forward(data, ptr, n),
                "index_add_": lambda: torch.zeros(n, f, device=dev).index_add_(0, ids, rows),
                "segment_reduce": lambda: torch.segment_reduce(rows, "sum", offsets=offsets),
            }
            try:
                calls["segment_reduce"]()
            except RuntimeError as err:  # a yardstick only: say so in the row
                calls.pop("segment_reduce")
                print(f"phase 6 K1 {name}: torch.segment_reduce does not take this shape "
                      f"on the card: {err}")
            # In turns: each call by CUDA events (L2 flushed) forwards, then
            # backwards; device time by the profiler.
            events = {k: [] for k in calls}
            for order in (list(calls), list(calls)[::-1]):
                for k in order:
                    events[k].append(time_ms(calls[k], flush))
            # Device events of one call: K1 one launch, index_add_ a fill
            # and the add; segment_reduce's are its own.
            per_call = {"kernel": 1, "index_add_": 2, "segment_reduce": None}
            device = {k: profile_device(fn, 20, per_call[k])[1] for k, fn in calls.items()}
            p_ms = time_ms(lambda: csr_segment.csr_segment_sum_count_plain(data, ptr, n), flush)
            nbytes = walked * f * 4 + n * f * 4 + n * 4 + (n + 1) * 4
            flops = walked * f
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            libs = [k for k in calls if k != "kernel"]
            records.append(dict(name=name, ms=events["kernel"][0], plain_ms=p_ms,
                                library_ms=min(events[k][0] for k in libs),
                                bound_ms=bound_ms, edges=walked, f=f))
            times = "; ".join(
                f"{k} {' / '.join(f'{t:.5f}' for t in events[k])} ms by events, "
                f"{'not measured' if device[k] is None else f'{device[k]:.5f} ms'} device"
                for k in calls)
            print(f"phase 6 K1 {name}: {times}; plain {p_ms:.5f} ms; bound "
                  f"{bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s; N={n}, walked E={walked}); "
                  f"kernel/bound {events['kernel'][0] / bound_ms:.1f}x by events"
                  + ("" if device["kernel"] is None else
                     f", {device['kernel'] / bound_ms:.1f}x by device time"))
        stats_records = []
        for name, data, mask, ids, ptr, n in timed_stats:
            e, f = data.shape
            calls = {
                "K5": lambda: csr_segment.csr_segment_stats_forward(data, mask, ptr, n),
                "parent bundle": lambda: parent_bundle(data, mask, ids, ptr, n),
            }
            events = {k: [] for k in calls}
            for order in (list(calls), list(calls)[::-1]):
                for k in order:
                    events[k].append(time_ms(calls[k], flush))
            device = {k: profile_device(fn, 20, 1 if k == "K5" else None)
                      for k, fn in calls.items()}
            p_ms = time_ms(lambda: csr_segment.csr_segment_stats_plain(data, mask, ptr, n), flush)
            # A masked row enters only as its mask byte (zeroed in the sums,
            # left out of min and max): count the kept rows' data, as for K2-K4.
            kept = e if mask is None else int(mask.sum())
            nbytes = kept * f * 4 + e + (n + 1) * 4 + 5 * n * f * 4 + n * 4
            bound_ms = max(nbytes / HBM_BYTES_PER_S, 6 * kept * f / F32_FLOPS) * 1e3
            stats_records.append(dict(name=name, ms=events["K5"][0], plain_ms=p_ms,
                                      library_ms=None, bound_ms=bound_ms, edges=e, f=f))
            times = "; ".join(f"{k} {' / '.join(f'{t:.5f}' for t in events[k])} ms by events "
                              f"({device[k][0]})" for k in calls)
            print(f"phase 6 K5 {name}: {times}; plain {p_ms:.5f} ms; bound "
                  f"{bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s; N={n}, E={e}, kept {kept}); "
                  f"K5/bound {events['K5'][0] / bound_ms:.1f}x by events"
                  + ("" if device["K5"][1] is None else
                     f", {device['K5'][1] / bound_ms:.1f}x by device time"))
        unsorted_records = {}
        for name, data, ids, n in timed2:
            e, f = data.shape
            # The kernel reads every id but only the rows it keeps (id >= 0);
            # the library call gets those rows and their ids ready-made.
            keep = ids >= 0
            kept = int(keep.sum())
            idx, rows = ids[keep].long(), data[keep]
            k_ms = time_ms(lambda: ssc.segment_sum_count_forward(data, ids, n), flush)
            p_ms = time_ms(lambda: ssc.segment_sum_count_plain(data, ids, n), flush)
            l_ms = time_ms(lambda: torch.zeros(n, f, device=dev).index_add_(0, idx, rows), flush)
            nbytes = e * 4 + kept * f * 4 + n * f * 4 + n * 4
            bound_ms = max(nbytes / HBM_BYTES_PER_S, kept * f / F32_FLOPS) * 1e3
            unsorted_records[f] = dict(name=name, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                       bound_ms=bound_ms, edges=e, f=f)
            print(f"phase 6 unsorted-id kernel {name}: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
                  f"index_add_ over the kept rows {l_ms:.5f} ms, bound {bound_ms * 1e3:.3f} us "
                  f"({nbytes} B at 3.35 TB/s; N={n}, E={e}, kept {kept}), "
                  f"kernel/bound {k_ms / bound_ms:.1f}x")

        skip_records = []
        for name, data, ids, n in timed_skip:
            e, f = data.shape
            keep = (ids >= 0) & (ids < n)
            kept = int(keep.sum())
            idx, rows = ids[keep].long(), data[keep]
            k_ms = time_ms(lambda: ssc.segment_sum_count_skip_forward(data, ids, n), flush)
            k2_ms = time_ms(lambda: ssc.segment_sum_count_forward(data, ids, n), flush)
            # Device time alone (the profiler, L2 not flushed): the CUDA-event
            # times hold the host's launch gaps between the passes.
            k_dev, _ = profile_device(lambda: ssc.segment_sum_count_skip_forward(data, ids, n), 20)
            k2_dev, _ = profile_device(lambda: ssc.segment_sum_count_forward(data, ids, n), 20)
            p_ms = time_ms(lambda: ssc.segment_sum_count_skip_plain(data, ids, n), flush)
            l_ms = time_ms(lambda: torch.zeros(n, f, device=dev).index_add_(0, idx, rows), flush)
            nbytes = e * 4 + kept * f * 4 + n * f * 4 + n * 4
            bound_ms = max(nbytes / HBM_BYTES_PER_S, kept * f / F32_FLOPS) * 1e3
            skip_records.append(dict(name=name, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                     bound_ms=bound_ms, edges=e, f=f))
            print(f"phase 6 K4 {name}: kernel {k_ms:.5f} ms ({k_dev}); K2/K3 "
                  f"on the same ids {k2_ms:.5f} ms ({k2_dev}); plain "
                  f"{p_ms:.5f} ms, index_add_ over the kept rows "
                  f"{l_ms:.5f} ms, bound {bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s; "
                  f"N={n}, E={e}, kept {kept}), kernel/bound {k_ms / bound_ms:.1f}x")

        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(batch), flush, reps=20, warmup=3)
        lat = []
        for _ in range(3):
            engine.predict(unlabeled(g256))
        before = len(engine.batch_seconds)
        for i in range(20):
            gs = unlabeled(predict_sets[i % 3])
            t0 = time.perf_counter()
            engine.predict(gs)
            lat.append(time.perf_counter() - t0)
        batch_s = list(engine.batch_seconds)[before:]
        p50 = statistics.median(lat)

        def forward():
            with torch.inference_mode():
                model(batch)

        breakdown, _ = profile_device(forward)
        print(f"phase 6 engine (256 graphs/batch, hidden 64): predict p50 {p50 * 1e3:.3f} ms, "
              f"{256 / p50:.1f} graphs/s; batch service p50 "
              f"{statistics.median(batch_s) * 1e3:.3f} ms over {len(batch_s)} batches; "
              f"forward on a resident batch {fwd_ms:.3f} ms (CUDA events)")
        print(f"phase 6 forward breakdown (torch.profiler, 10 forwards): {breakdown}")

        step_ms = time_ms(lambda: train_step(tmodel, topt, tbatch), flush, reps=20, warmup=3)
        step_breakdown, _ = profile_device(lambda: train_step(tmodel, topt, tbatch), reps=5)
        print(f"phase 6 train step (256 graphs, hidden 64, AdamW, resident batch): p50 "
              f"{step_ms:.3f} ms (CUDA events), {BATCH_GRAPHS / (step_ms / 1e3):.1f} train graphs/s")
        print(f"phase 6 train step breakdown (torch.profiler, 5 steps): {step_breakdown}")
    finally:
        engine.close()

    # ---- phase 7: the other conv families
    skip_k4 = families_phase(dev, g256, host256)

    head = records[2]  # the readout: PNA's K1 launch on the main path
    stats = stats_records[1]  # layers 1-2 of the flagship
    k2, k3 = unsorted_records[64], unsorted_records[256]
    kernels = [
        {
            "name": "csr_segment_sum_count",
            "route": "cuda",
            "source": "hydragnn_tpu_torch/ops/csrc/csr_segment.cu",
            "replaces": "hydragnn_tpu/ops/pallas_segment.py:374",
            "launches": serve_k1 + train_k1,
            "max_abs_err": max_abs_err,
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": "bytes",
            "library_ms": head["library_ms"],
            "shape": f"{head['name']}: E={head['edges']} F={head['f']}",
        },
        {
            "name": "csr_segment_stats (K5)",
            "route": "cuda",
            "source": "hydragnn_tpu_torch/ops/csrc/csr_stats.cu",
            "replaces": "hydragnn_tpu/ops/pallas_segment.py:650",
            "launches": serve_k5 + train_k5,
            "max_abs_err": stats_err,
            "ms": stats["ms"],
            "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": f"{stats['name']}: E={stats['edges']} F={stats['f']}",
        },
    ]
    for label, rec, launches, err, line in (
        ("F <= 64", k2, unsorted_small, unsorted_errs["k2"], 154),
        ("F > 64", k3, unsorted_wide, unsorted_errs["k3"], 172),
    ):
        kernels.append({
            "name": f"segment_sum_count ({label})",
            "route": "cuda",
            "source": "hydragnn_tpu_torch/ops/csrc/segment_sum_count.cu",
            "replaces": f"hydragnn_tpu/ops/pallas_segment.py:{line}",
            "launches": launches,
            "max_abs_err": err,
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": "bytes",
            "library_ms": rec["library_ms"],
            "shape": f"{rec['name']}: E={rec['edges']} F={rec['f']}",
        })
    k4 = skip_records[0]
    kernels.append({
        "name": "segment_sum_count_skip (K4)",
        "route": "cuda",
        "source": "hydragnn_tpu_torch/ops/csrc/segment_skip.cu",
        "replaces": "hydragnn_tpu/ops/pallas_segment.py:223",
        "launches": skip_k4,
        "max_abs_err": skip_err,
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k4["library_ms"],
        "shape": f"{k4['name']}: E={k4['edges']} F={k4['f']}",
    })
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    print(f"main-path launches: K1 serve {serve_k1} + train {train_k1}; K5 serve {serve_k5} + "
          f"train {train_k5}; unsorted-id F<=64 "
          f"{unsorted_small}, F>64 {unsorted_wide}; K4 (the families' forwards without CSR "
          f"pointers under the skip switch) {skip_k4}")
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
