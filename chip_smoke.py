#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``hydragnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device and build: the card's name and power limit (``nvidia-smi``), and
   the CUDA kernels built from ``hydragnn_tpu_torch/ops/csrc`` with
   ``nvcc``, one compiler per source, all started together;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the flagship model gives it and at edge cases: K1 (CSR runs), the
   unsorted-id kernel (K2/K3: batches without CSR pointers) and, in 2c, the
   block-skip kernel (K4: batches without CSR pointers under
   ``HYDRAGNN_PALLAS_SKIP=1``), also against K2/K3;
3. serving: the flagship PNA model (hidden 64, 3 layers, graph + node
   heads, random weights from seed 0) behind ``InferenceEngine`` answers
   three 256-graph ``predict`` calls and 8 lone ``submit`` calls; every
   batch forward must launch K1 7 times (3 layers x 2 PNA passes + the
   readout pool), and the same model on the CPU must agree; then the same
   batch without ``row_ptr``/``graph_ptr``: 7 launches of the unsorted-id
   kernel and none of K1, outputs equal to the CSR forward;
4. full width: hidden 256 on one 512-graph batch, the same checks, with and
   without CSR pointers (the F > 64 launches of the unsorted-id kernel);
5. training: ``train_validate_test`` over ``TrainingDriver(...,
   device="cuda")`` for 3 epochs of 8 train, 2 val and 2 test batches of 256
   graphs (AdamW, ``ReduceLROnPlateau``): the losses finite and falling, 7
   K1 launches per forward and none from the backward; on each train batch
   one step's loss (rtol 1e-5) and gradients (rtol 1e-4 + atol 1e-5 x each
   tensor's largest gradient, see :func:`grad_gap`) on the card against the
   CPU, the CPU's backward taking the card's side of every ReLU and min/max
   kink (see :class:`Kinks`), and on a batch without CSR pointers against the
   CSR step;
6. times: each kernel, its plain version, ``index_add_`` over the kept
   rows and the memory bound at the flagship shapes (K4 beside K2/K3 on the
   same ids), the engine's batch latency, the train
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
KERNELS = ("csr_segment", "segment_sum_count", "segment_skip")
TRAIN_BATCHES, EVAL_BATCHES, EPOCHS, BATCH_GRAPHS = 8, 2, 3, 256
FAMILIES = ("SAGE", "GIN", "MFC", "GAT", "CGCNN")
FAMILY_TRAIN_BATCHES = 4
GAT_HEADS = 6


def launches_per_forward(family):
    """(sum, count) kernel calls of one forward: one aggregation per layer
    (GAT two: the softmax denominator and the weighted sum; PNA two: the
    mean and the centred-std passes) and the readout pool."""
    return (2 if family in ("GAT", "PNA") else 1) * LAYERS + 1


LAUNCHES_PER_FORWARD = launches_per_forward("PNA")


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
    ssc.KERNEL_LAUNCHES = 0
    ssc.WIDE_LAUNCHES = 0
    ssc.SKIP_LAUNCHES = 0


def read_counts():
    """Launches since :func:`zero_counts`: K1, the unsorted-id kernel (and
    of those the launches at F > 64), and the block-skip kernel K4."""
    from hydragnn_tpu_torch.ops import csr_segment
    from hydragnn_tpu_torch.ops import segment_sum_count as ssc

    return {"k1": csr_segment.KERNEL_LAUNCHES, "k2": ssc.KERNEL_LAUNCHES,
            "wide": ssc.WIDE_LAUNCHES, "k4": ssc.SKIP_LAUNCHES}


def counted(run, where, k1, k2, wide=0, k4=0):
    """``run()`` with every count zeroed just before; raises unless the
    counts read just after are exactly (k1, k2, wide, k4)."""
    zero_counts()
    out = run()
    got = read_counts()
    want = {"k1": k1, "k2": k2, "wide": wide, "k4": k4}
    if got != want:
        raise AssertionError(f"{where}: kernel launches {got} != {want}")
    return out, got


def serve_with_counts(engine, calls, per_forward=LAUNCHES_PER_FORWARD):
    """Run ``calls(engine)`` with the kernels' launch counts zeroed just
    before; returns (result, K1 launches, batch forwards)."""
    before = engine.batches_run
    zero_counts()
    out = calls(engine)
    counts = read_counts()
    batches = engine.batches_run - before
    if batches == 0 or counts != {"k1": per_forward * batches, "k2": 0, "wide": 0, "k4": 0}:
        raise AssertionError(
            f"kernel launches {counts} != {per_forward} x {batches} batch forwards of K1"
        )
    return out, counts["k1"], batches


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


def tensor_gaps(got, want, names, widen=None):
    """Per parameter, max over its gradient entries of |got - want| / (1e-4
    |want| + 1e-5 max|g|); <= 1 passes. ``max|g|`` is the tensor's own
    largest entry of ``want``, except for a tensor whose gradient is at
    rounding level (its largest entry below ``ROUNDING_LEVEL`` x the step's
    largest): it is held to the step's largest entry. Each conv's last bias
    is such a tensor: its gradient is zero analytically (the train-mode
    batch norm after it subtracts the batch mean), so what either side
    holds is rounding noise. ``widen`` multiplies a tensor's ``max|g|`` (see
    :func:`f32_widening`). Returns ([(name, gap)], the rounding-level
    tensors)."""
    got = [a.detach().double().cpu() for a in got]
    want = [b.detach().double().cpu() for b in want]
    step = max(float(b.abs().max()) for b in want)
    gaps, noise = [], []
    for name, a, b in zip(names, got, want):
        own = float(b.abs().max())
        if own < ROUNDING_LEVEL * step:
            noise.append(f"{name} ({own / step:.1e})")
            own = step
        own *= (widen or {}).get(name, 1.0)
        gaps.append((name, float(((a - b).abs() / (1e-4 * b.abs() + 1e-5 * own)).max())))
    return gaps, noise


def grad_gap(got, want, names, widen=None):
    """(the largest of :func:`tensor_gaps`, the parameter where it is
    reached, the rounding-level tensors). The backward's ``index_add_``
    (the gather of the message inputs) sums in a varying order on the
    card."""
    gaps, noise = tensor_gaps(got, want, names, widen)
    where, worst = max(reversed(gaps), key=lambda g: g[1])
    return worst, where, noise


F32_HEADROOM = 6.0  # tolerance / the CPU's own f32 miss, where that miss is large


def f32_widening(cpu_grads, truth_grads, names):
    """``{name: factor}`` for the tensors that f32 arithmetic cannot hold to
    their own scale: those on which the CPU's f32 gradient is further than
    ``1 / F32_HEADROOM`` of the tolerance from the f64 gradient of the same
    step (same weights, batch and kink sides). A gradient that sums many
    terms which cancel (GAT's first ``lin_src.bias``: its message path adds
    a constant per channel that the batch norm removes, so ~4700 node terms
    cancel to a small remainder; GIN's ``eps``) carries an f32 rounding
    error of the terms' size, not of its own. The card's error there varies
    from run to run (its backward's ``index_add_`` adds in a varying order)
    and has read up to 3x the CPU's one sampled miss. Such a tensor's
    ``max|g|`` is widened by ``F32_HEADROOM x`` that miss, the scale at
    which the CPU's own f32 result uses ``1 / F32_HEADROOM`` of the
    tolerance; every other tensor keeps its own scale."""
    gaps, _ = tensor_gaps(cpu_grads, truth_grads, names)
    return {name: F32_HEADROOM * gap for name, gap in gaps if gap * F32_HEADROOM > 1.0}


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
    and each ``segment_extrema`` call which rows attain the extrema (in call
    order, on the CPU); inside :meth:`replay` each backward takes the
    recorded ones, and ``differ`` counts the entries where the CPU's own
    were others (leaky ReLU's under "relu")."""

    def __init__(self):
        self.sides = []
        self.differ = {"relu": 0, "min/max": 0}

    @contextlib.contextmanager
    def _patched(self, relu, extrema, leaky):
        import torch
        from torch.nn import functional

        from hydragnn_tpu_torch.ops import csr_segment

        originals = torch.relu, csr_segment.segment_extrema, functional.leaky_relu
        torch.relu = lambda x: relu(originals[0], x)
        csr_segment.segment_extrema = lambda data, ids, n: extrema(originals[1], data, ids, n)
        functional.leaky_relu = lambda x, slope=0.01: leaky(originals[2], x, slope)
        try:
            yield self
        finally:
            torch.relu, csr_segment.segment_extrema, functional.leaky_relu = originals

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

        return self._patched(relu, extrema, leaky)

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

        return self._patched(relu, extrema, leaky)


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
    if "csr_sum_count_kernel" in name or "long_run_partials_kernel" in name:
        return "segment run walk (K1)"
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


def profile_device(run, reps=10):
    """Device time per call of ``run`` by kernel group, and the device's
    idle share of the window, from ``torch.profiler``. Only the device's own
    events (kernels, copies, sets) are counted, each once: an operator's
    CPU-side row also carries its kernels' time. Raises if the device's busy
    time exceeds the wall time that encloses it; "not measured" where the
    profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    spans = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        group = _group(evt.name)
        groups[group] = groups.get(group, 0.0) + (end - start)
    if not spans:
        return "not measured (the profiler recorded no device event)"
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):  # union of the device's busy intervals
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    if busy_us > wall_us:
        raise AssertionError(f"profiler: device busy {busy_us:.1f} us > wall {wall_us:.1f} us")
    device_us = sum(groups.values())
    parts = ", ".join(
        f"{k} {v / reps / 1e3:.4f} ms ({100 * v / device_us:.1f}%)"
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])
    )
    return (f"device busy {busy_us / reps / 1e3:.4f} ms/call of {wall_us / reps / 1e3:.4f} ms "
            f"wall, idle share {1.0 - busy_us / wall_us:.4f}; {len(spans) // reps} device "
            f"events/call; {parts}")


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
    """One train step from ``model``'s weights on the card (K1 launched
    ``per_forward`` times, nothing else) and on the CPU, the CPU's backward
    on the card's side of every kink; raises unless the losses agree within
    rtol 1e-5 and the gradient gap (:func:`grad_gap`) is <= 1. Returns
    (kinks, card loss, card gradients, CPU gradients, gap, where, the
    rounding-level tensors, the gap on the CPU's own sides)."""
    from hydragnn_tpu_torch.graphs import GraphBatch
    from hydragnn_tpu_torch.train import loss_and_grads

    kinks = Kinks()
    with kinks.record():
        (loss, _, grads), _ = counted(lambda: loss_and_grads(copy.deepcopy(model), batch),
                                      label, k1=per_forward, k2=0)
    cpu_batch = GraphBatch.from_numpy(host, "cpu")
    cpu_loss, _, raw_grads = loss_and_grads(copy.deepcopy(cpu_model), cpu_batch)
    with kinks.replay():
        _, _, cpu_grads = loss_and_grads(copy.deepcopy(cpu_model), cpu_batch)
    # The same step in f64 on the CPU (same kink sides): what f32 can resolve.
    truth_kinks = Kinks()
    truth_kinks.sides = kinks.sides
    with truth_kinks.replay():
        _, _, truth = loss_and_grads(copy.deepcopy(cpu_model).double(), as_double(cpu_batch))
    widen = f32_widening(cpu_grads, truth, names)
    if not abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss)):
        raise AssertionError(f"{label}: loss card {float(loss)} vs CPU {float(cpu_loss)}")
    gap, where, noise = grad_gap(grads, cpu_grads, names, widen)
    raw, raw_where, _ = grad_gap(grads, raw_grads, names, widen)
    print(f"{label}: loss {float(loss):.7f} / {float(cpu_loss):.7f}; gradient gap {gap:.4f} "
          f"at {where} on the card's side of every kink (the CPU's own side differed at "
          f"{kinks.differ['relu']} ReLU and {kinks.differ['min/max']} min/max entries; gap on "
          f"its own sides {raw:.4f} at {raw_where}); f32-limited, max|g| widened "
          f"{ {k: round(v, 3) for k, v in widen.items()} }")
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
            res, launches, batches = serve_with_counts(
                engine, lambda eng: eng.predict(unlabeled(graphs)), per_forward)
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
                                         k1=0, k2=0, k4=per_forward)
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
                                f"phase 7 {family} training", k1=per_forward * forwards, k2=0)
        losses = hist["total_loss_train"]
        if not (np.isfinite(losses).all() and np.isfinite(hist["total_loss_val"]).all()):
            raise AssertionError(f"phase 7 {family} training: non-finite history {hist}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"phase 7 {family} training: train loss did not fall: {losses}")
        print(f"phase 7 {family}: serve {batches} batch forward(s), {launches} K1 launches "
              f"({per_forward} per forward), card vs CPU gap {gap:.4f}; without CSR pointers "
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
        "training", k1=LAUNCHES_PER_FORWARD * forwards, k2=0)
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
          f"{counts['k1']} K1 launches = {LAUNCHES_PER_FORWARD} x {forwards} forwards (none "
          f"from the backward), 0 unsorted-id; train loss {[round(v, 6) for v in train_loss]}, "
          f"val {[round(v, 6) for v in hist['total_loss_val']]}, test "
          f"{[round(v, 6) for v in hist['total_loss_test']]}; {wall:.2f} s wall "
          f"({EPOCHS * TRAIN_BATCHES * BATCH_GRAPHS / wall:.1f} train graphs/s with the "
          f"evaluations and host collation inside)")
    main_k1 = counts["k1"]

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
            "train step without CSR pointers", k1=0, k2=LAUNCHES_PER_FORWARD)
    bgap, bwhere, bnoise = grad_gap(bare_grads, grads, names)
    if not abs(float(bare_loss) - float(loss)) <= 1e-5 * abs(float(loss)) or bgap > 1.0:
        raise AssertionError(f"train step without CSR: loss {float(bare_loss)} vs "
                             f"{float(loss)}, gradient gap {bgap:.3f} at {bwhere}")
    print(f"phase 5 one train step without CSR pointers: {bare_counts['k2']} unsorted-id launches, "
          f"0 K1; loss {float(bare_loss):.7f}, gradients vs the CSR step's worst {bgap:.4f} "
          f"of the tolerance, at {bwhere}, on the CSR step's side of every kink (its own "
          f"side differed at {bare_kinks.differ['relu']} ReLU and "
          f"{bare_kinks.differ['min/max']} min/max entries); rounding-level: {bnoise}")
    return model, opt, batch, main_k1, bare_counts


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

        (results, singles), launches, batches = serve_with_counts(engine, main_path)
        for gs, res in zip(predict_sets, results):
            check_outputs(res, gs, "serve predict")
        check_outputs(singles, lone, "serve submit")
        print(f"phase 3 serve: 3 x 256-graph predicts + 8 submits -> {batches} batch "
              f"forwards, {launches} K1 launches ({LAUNCHES_PER_FORWARD} per forward), "
              f"ladder fallbacks {engine.ladder_fallbacks}")
        serve_k1 = launches

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
            bare_out, bare = counted(lambda: model(without_pointers(batch)),
                                     "forward without CSR pointers", k1=0, k2=LAUNCHES_PER_FORWARD)
        bgap = max_rel_gap([real_rows(bare_out, host256)], [real_rows(csr_out, host256)])
        if bgap > 1.0:
            raise AssertionError(f"forward without CSR vs CSR forward gap {bgap:.3f} > 1")
        print(f"phase 3 forward without CSR pointers: {bare['k2']} unsorted-id launches, 0 K1; "
              f"outputs vs the CSR forward {bgap:.4f} of rtol={RTOL}, atol={ATOL}")
        unsorted_small = bare["k2"] - bare["wide"]

        # ---- phase 4: full width
        wide = build_model(256, "cuda")
        wide_top = compute_pad_sizes(wide_graphs, 512)[:2]
        wide_engine = InferenceEngine(wide, device="cuda", max_batch_graphs=512,
                                      max_delay_ms=50.0, queue_limit=512, bucket_ladder=[wide_top])
        try:
            wide_res, wl, wb = serve_with_counts(
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
        print(f"phase 4 full width (hidden 256, 512 graphs): {wb} batch forwards, {wl} K1 "
              f"launches, card vs CPU gap {wgap:.4f} <= 1")
        wbatch = GraphBatch.from_numpy(host512, dev)
        # Layer 0 aggregates F=1 messages; layers 1-2 and the readout F=256.
        wide_passes = 2 * (LAYERS - 1) + 1
        with torch.inference_mode():
            w_csr = wide(wbatch)
            w_bare, wcounts = counted(lambda: wide(without_pointers(wbatch)),
                                      "full width without CSR pointers", k1=0,
                                      k2=LAUNCHES_PER_FORWARD, wide=wide_passes)
        w_bgap = max_rel_gap([real_rows(w_bare, host512)], [real_rows(w_csr, host512)])
        if w_bgap > 1.0:
            raise AssertionError(f"full width without CSR vs CSR gap {w_bgap:.3f} > 1")
        print(f"phase 4 full width without CSR pointers: {wcounts['k2']} unsorted-id launches "
              f"({wcounts['wide']} at F=256), 0 K1; outputs vs the CSR forward {w_bgap:.4f}")
        unsorted_small += wcounts["k2"] - wcounts["wide"]
        unsorted_wide = wcounts["wide"]
        del wide, w_csr, w_bare

        # ---- phase 5: training
        tmodel, topt, tbatch, train_k1, step_counts = train_phase(dev)
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
            k_ms = time_ms(lambda: csr_segment.csr_segment_sum_count_forward(data, ptr, n), flush)
            p_ms = time_ms(lambda: csr_segment.csr_segment_sum_count_plain(data, ptr, n), flush)
            l_ms = time_ms(lambda: torch.zeros(n, f, device=dev).index_add_(0, ids, rows), flush)
            nbytes = walked * f * 4 + n * f * 4 + n * 4 + (n + 1) * 4
            flops = walked * f
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            records.append(dict(name=name, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=bound_ms, bytes=nbytes, edges=walked, f=f))
            print(f"phase 6 K1 {name}: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
                  f"index_add_ {l_ms:.5f} ms, bound {bound_ms * 1e3:.3f} us "
                  f"({nbytes} B at 3.35 TB/s; N={n}, walked E={walked}), "
                  f"kernel/bound {k_ms / bound_ms:.1f}x")
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
            k_dev = profile_device(lambda: ssc.segment_sum_count_skip_forward(data, ids, n), 20)
            k2_dev = profile_device(lambda: ssc.segment_sum_count_forward(data, ids, n), 20)
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

        breakdown = profile_device(forward)
        print(f"phase 6 engine (256 graphs/batch, hidden 64): predict p50 {p50 * 1e3:.3f} ms, "
              f"{256 / p50:.1f} graphs/s; batch service p50 "
              f"{statistics.median(batch_s) * 1e3:.3f} ms over {len(batch_s)} batches; "
              f"forward on a resident batch {fwd_ms:.3f} ms (CUDA events)")
        print(f"phase 6 forward breakdown (torch.profiler, 10 forwards): {breakdown}")

        step_ms = time_ms(lambda: train_step(tmodel, topt, tbatch), flush, reps=20, warmup=3)
        step_breakdown = profile_device(lambda: train_step(tmodel, topt, tbatch), reps=5)
        print(f"phase 6 train step (256 graphs, hidden 64, AdamW, resident batch): p50 "
              f"{step_ms:.3f} ms (CUDA events), {BATCH_GRAPHS / (step_ms / 1e3):.1f} train graphs/s")
        print(f"phase 6 train step breakdown (torch.profiler, 5 steps): {step_breakdown}")
    finally:
        engine.close()

    # ---- phase 7: the other conv families
    skip_k4 = families_phase(dev, g256, host256)

    head = records[0]
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
    print(f"main-path launches: K1 serve {serve_k1} + train {train_k1}; unsorted-id F<=64 "
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
