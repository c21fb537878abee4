#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``hydragnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device and build: the card's name and power limit (``nvidia-smi``), and
   the CUDA kernel built from ``hydragnn_tpu_torch/ops/csrc`` with ``nvcc``;
2. the kernel against its plain PyTorch version on the card, at the shapes
   the flagship model gives it and at edge cases;
3. serving: the flagship PNA model (hidden 64, 3 layers, graph + node
   heads, random weights from seed 0) behind ``InferenceEngine`` answers
   three 256-graph ``predict`` calls and 8 lone ``submit`` calls; every
   batch forward must launch the kernel 7 times (3 layers x 2 PNA passes +
   the readout pool), and the same model on the CPU must agree;
4. full width: hidden 256 on one 512-graph batch, the same checks;
5. times: the kernel, its plain version, ``index_add_`` and the memory
   bound at the flagship shapes, and the engine's batch latency.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA device; without one it
exits non-zero at once.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

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
LAUNCHES_PER_FORWARD = 2 * LAYERS + 1

# H100 SXM data-sheet peaks (the bound is against these, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
RTOL, ATOL = 1e-4, 1e-5  # port on the card vs the same model on the CPU


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


def build_model(hidden, device):
    import torch

    from hydragnn_tpu_torch.models import create_model

    return create_model(
        "PNA", 1, hidden, DIMS, TYPES, HEADS, [1.0, 1.0], LAYERS,
        edge_dim=1, pna_deg=PNA_DEG, device=device,
        generator=torch.Generator().manual_seed(0),
    )


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


def serve_with_counts(engine, calls):
    """Run ``calls(engine)`` with the kernel's launch count zeroed just
    before; returns (result, launches, batch forwards)."""
    from hydragnn_tpu_torch.ops import csr_segment

    before = engine.batches_run
    csr_segment.KERNEL_LAUNCHES = 0
    out = calls(engine)
    launches = csr_segment.KERNEL_LAUNCHES
    batches = engine.batches_run - before
    if batches == 0 or launches != LAUNCHES_PER_FORWARD * batches:
        raise AssertionError(
            f"kernel launches {launches} != {LAUNCHES_PER_FORWARD} x {batches} batch forwards"
        )
    return out, launches, batches


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


def profile_forward(model, batch, reps=10):
    """Device time per forward by kernel group, and the device's idle share
    of the window, from ``torch.profiler``. Only the device's own events
    (kernels, copies, sets) are counted, each once: an operator's CPU-side
    row also carries its kernels' time. Raises if the device's busy time
    exceeds the wall time that encloses it; "not measured" where the
    profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(batch)
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
        name = evt.name
        if "csr_sum_count_kernel" in name or "long_run_partials_kernel" in name:
            group = "K1 csr_sum_count"
        elif "gemm" in name or "sm90" in name or "cutlass" in name or "matmul" in name:
            group = "matmul"
        elif "scatter" in name or "index" in name or "gather" in name:
            group = "index/scatter"
        elif "Memcpy" in name or "Memset" in name:
            group = "copies/sets"
        else:
            group = "other elementwise"
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
    return (f"device busy {busy_us / reps / 1e3:.4f} ms/forward of {wall_us / reps / 1e3:.4f} ms "
            f"wall, idle share {1.0 - busy_us / wall_us:.4f}; {len(spans) // reps} device "
            f"events/forward; {parts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script drives "
              "the port on a GPU and has no CPU mode", file=sys.stderr)
        return 2
    from hydragnn_tpu_torch.graphs import GraphBatch, collate_graphs, compute_pad_sizes
    from hydragnn_tpu_torch.models import multihead_rmse_loss
    from hydragnn_tpu_torch.ops import _build, csr_segment
    from hydragnn_tpu_torch.serve import InferenceEngine
    from hydragnn_tpu_torch.utils import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- phase 1: build
    path, log, build_s = _build.build("csr_segment")
    print(f"phase 1 build: {build_s:.2f} s -> {path.name}")
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

    # ---- phase 2: kernel vs plain on the card
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
        got_s, got_c = csr_segment.csr_segment_sum_count(data, ptr, n)
        again_s, _ = csr_segment.csr_segment_sum_count(data, ptr, n)
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
              f"forwards, {launches} kernel launches ({LAUNCHES_PER_FORWARD} per forward), "
              f"ladder fallbacks {engine.ladder_fallbacks}")
        main_launches = launches

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
        print(f"phase 4 full width (hidden 256, 512 graphs): {wb} batch forwards, {wl} kernel "
              f"launches, card vs CPU gap {wgap:.4f} <= 1")

        # ---- phase 5: times
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
            k_ms = time_ms(lambda: csr_segment.csr_segment_sum_count(data, ptr, n), flush)
            p_ms = time_ms(lambda: csr_segment.csr_segment_sum_count_plain(data, ptr, n), flush)
            l_ms = time_ms(lambda: torch.zeros(n, f, device=dev).index_add_(0, ids, rows), flush)
            nbytes = walked * f * 4 + n * f * 4 + n * 4 + (n + 1) * 4
            flops = walked * f
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            records.append(dict(name=name, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=bound_ms, bytes=nbytes, edges=walked, f=f))
            print(f"phase 5 K1 {name}: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
                  f"index_add_ {l_ms:.5f} ms, bound {bound_ms * 1e3:.3f} us "
                  f"({nbytes} B at 3.35 TB/s; N={n}, walked E={walked}), "
                  f"kernel/bound {k_ms / bound_ms:.1f}x")

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
        breakdown = profile_forward(model, batch)
        print(f"phase 5 engine (256 graphs/batch, hidden 64): predict p50 {p50 * 1e3:.3f} ms, "
              f"{256 / p50:.1f} graphs/s; batch service p50 "
              f"{statistics.median(batch_s) * 1e3:.3f} ms over {len(batch_s)} batches; "
              f"forward on a resident batch {fwd_ms:.3f} ms (CUDA events)")
        print(f"phase 5 forward breakdown (torch.profiler, 10 forwards): {breakdown}")
    finally:
        engine.close()

    head = records[0]
    kernel = {
        "name": "csr_segment_sum_count",
        "route": "cuda",
        "source": "hydragnn_tpu_torch/ops/csrc/csr_segment.cu",
        "replaces": "hydragnn_tpu/ops/pallas_segment.py:374",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "shape": f"{head['name']}: E={head['edges']} F={head['f']}",
    }
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
