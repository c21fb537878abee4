"""Online inference engine: micro-batching over the padded-arena collator.

One worker thread pops requests from a bounded queue and flushes a
micro-batch when it holds ``max_batch_graphs`` graphs or ``max_delay_ms``
after its first request. A flush is collated by ``GraphArena`` into the
smallest bucket of the ladder it fits (``G_pad = max_batch_graphs + 1``
always), copied to the device in one ``GraphBatch.from_numpy``, run forward
under ``torch.inference_mode()``, and split back per graph: a graph head's
row ``g``, a node head's rows of that graph's nodes.

``submit`` on a full queue raises :class:`BackpressureError`. A collation
failure fails that batch's requests only; a failure of the forward kills the
worker, fails every pending request and makes later calls raise
:class:`EngineFailedError`.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphs.batch import GraphBatch
from ..graphs.collate import GraphArena, round_up_pow2
from ..graphs.sample import GraphSample
from ..utils.device import resolve_device


class BackpressureError(RuntimeError):
    """The bounded request queue is full; retry after ``retry_after_s``."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class EngineClosedError(RuntimeError):
    """The engine was shut down before the request resolved."""


class EngineFailedError(RuntimeError):
    """The worker thread died; the original exception is ``__cause__``."""


@dataclass
class _Request:
    sample: GraphSample
    future: Future
    t_submit: float


_SHUTDOWN = object()


def _settle(fut: Future, result=None, exc: Optional[BaseException] = None) -> None:
    """Resolve ``fut``; a future the caller already cancelled is left so."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class InferenceEngine:
    """Micro-batching online inference over a port ``HydraGNN``.

    Parameters
    ----------
    model:
        The model to serve; it is moved to ``device`` and put in eval mode.
    device:
        ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    max_batch_graphs:
        Flush at this many graphs; every batch has ``G_pad =
        max_batch_graphs + 1``.
    max_delay_ms:
        Flush an open batch this long after its first request.
    queue_limit:
        Bounded queue depth; beyond it ``submit`` raises
        :class:`BackpressureError`.
    bucket_ladder:
        ``(N_pad, E_pad)`` shapes; a batch takes the smallest it fits, else
        the power-of-two round-up (counted in ``ladder_fallbacks``).
    """

    def __init__(
        self,
        model,
        *,
        device="cuda",
        max_batch_graphs: int = 32,
        max_delay_ms: float = 5.0,
        queue_limit: int = 256,
        bucket_ladder: Optional[Sequence[Tuple[int, int]]] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch_graphs = int(max_batch_graphs)
        self.max_delay_ms = float(max_delay_ms)
        self.queue_limit = int(queue_limit)
        self._g_pad = self.max_batch_graphs + 1
        self._edge_dim = model.edge_dim if model.use_edge_attr else 0
        self._ladder = sorted((int(n), int(e)) for n, e in (bucket_ladder or ()))

        self._queue: "queue.Queue" = queue.Queue(maxsize=self.queue_limit)
        self._lock = threading.Lock()
        self._pending: set = set()  # guarded-by: self._lock
        self._closing = threading.Event()
        self._error: Optional[BaseException] = None
        # Counters read by callers after a run: forwards executed, ladder
        # misses, and the service time (flush → outputs on the host) of the
        # most recent batches.
        self.batches_run = 0  # guarded-by: self._lock
        self.ladder_fallbacks = 0  # guarded-by: self._lock
        self.batch_seconds: "deque[float]" = deque(maxlen=4096)  # guarded-by: self._lock
        self._worker = threading.Thread(
            target=self._run, name="hydragnn-torch-serve", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------ lifecycle
    @property
    def running(self) -> bool:
        return self._worker.is_alive()

    def close(self, timeout: float = 10.0) -> None:
        """Serve what was flushed, stop the worker, fail the stragglers."""
        if self._closing.is_set():
            return
        self._closing.set()
        # The shutdown marker must reach the worker even under a full queue:
        # evict (and fail) queued requests until it fits.
        while True:
            try:
                self._queue.put_nowait(_SHUTDOWN)
                break
            except queue.Full:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    continue
                if req is not _SHUTDOWN:
                    self._reject(req, EngineClosedError("engine closing"))
        self._worker.join(timeout)
        self._fail_pending(EngineClosedError("engine closed"))

    # ------------------------------------------------------------- requests
    def submit(self, sample: GraphSample) -> Future:
        """Enqueue one graph; the future resolves to its per-head outputs
        (``[dim]`` for graph heads, ``[n, dim]`` for node heads)."""
        if self._error is not None:
            raise EngineFailedError("inference worker died") from self._error
        if self._closing.is_set():
            raise EngineClosedError("engine is shut down")
        self._validate(sample)
        req = _Request(sample=sample, future=Future(), t_submit=time.perf_counter())
        with self._lock:
            self._pending.add(req.future)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._lock:
                self._pending.discard(req.future)
            hint = max(0.05, self.max_delay_ms / 1000.0)
            raise BackpressureError(
                f"request queue full ({self.queue_limit}); retry in ~{hint:.2f}s",
                retry_after_s=hint,
            ) from None
        # A close() or worker death between the checks above and the enqueue
        # may leave the request behind the worker's last pop: fail it here.
        if self._closing.is_set() or self._error is not None:
            self._reject(req, EngineClosedError("engine closed during submit"))
        return req.future

    def predict(
        self, samples: Sequence[GraphSample], timeout: Optional[float] = 60.0
    ) -> List[List[np.ndarray]]:
        """Submit all, wait for all; one per-head output list per graph."""
        for s in samples:
            self._validate(s)
        if len(samples) > self.queue_limit:
            raise ValueError(
                f"predict() of {len(samples)} graphs exceeds queue_limit "
                f"{self.queue_limit}; split the call or raise the limit"
            )
        futures = []
        try:
            for s in samples:
                futures.append(self.submit(s))
        except BackpressureError:
            # The admitted graphs compute regardless: let them finish so
            # the engine is quiet for the caller's retry.
            for f in futures:
                f.exception(timeout)
            raise
        return [f.result(timeout) for f in futures]

    def _validate(self, sample: GraphSample) -> None:
        x = sample.x
        if x is None or np.ndim(x) != 2:
            raise ValueError("sample.x must be a [num_nodes, F] array")
        if x.shape[1] != self.model.input_dim:
            raise ValueError(
                f"sample.x feature width {x.shape[1]} != model input_dim "
                f"{self.model.input_dim}"
            )
        if sample.edge_index is not None:
            ei = np.asarray(sample.edge_index)
            if ei.ndim != 2 or ei.shape[0] != 2:
                raise ValueError("sample.edge_index must be [2, num_edges]")
            # Out-of-range ids would alias onto a co-batched graph's nodes.
            if ei.size and (ei.min() < 0 or ei.max() >= sample.num_nodes):
                raise ValueError("sample.edge_index references nodes outside the graph")
        if self._edge_dim and sample.num_edges:
            ea = sample.edge_attr
            if ea is None:
                raise ValueError(
                    f"model expects edge_attr of width {self._edge_dim}; "
                    "request carries none"
                )
            if np.ndim(ea) != 2 or np.shape(ea) != (sample.num_edges, self._edge_dim):
                raise ValueError(
                    f"sample.edge_attr must be [{sample.num_edges}, "
                    f"{self._edge_dim}], got shape {np.shape(ea)}"
                )

    # ----------------------------------------------------------- the worker
    def _run(self) -> None:
        try:
            while True:
                entries, shutdown = self._next_flush()
                if entries:
                    self._serve(entries)
                if shutdown:
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised to callers
            self._error = e
            failed = EngineFailedError("inference worker died")
            failed.__cause__ = e
            self._fail_pending(failed)

    def _next_flush(self) -> Tuple[List[_Request], bool]:
        """Block for a first request, then gather until the batch is full or
        its deadline passes. Returns ``(requests, saw_shutdown)``."""
        while True:
            try:
                first = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                if self._closing.is_set():
                    return [], True
        if first is _SHUTDOWN:
            return [], True
        entries = [first]
        deadline = time.perf_counter() + self.max_delay_ms / 1000.0
        while len(entries) < self.max_batch_graphs:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                return entries, True
            entries.append(nxt)
        return entries, False

    def _bucket_shape(self, tot_nodes: int, tot_edges: int) -> Tuple[int, int, bool]:
        """Smallest ladder ``(N_pad, E_pad)`` with ``N_pad > tot_nodes`` and
        ``E_pad >= tot_edges``, else the power-of-two round-up (flagged as a
        fallback when a ladder exists)."""
        for n, e in self._ladder:
            if n > tot_nodes and e >= tot_edges:
                return n, e, False
        return (
            round_up_pow2(tot_nodes + 1),
            round_up_pow2(max(tot_edges, 1)),
            bool(self._ladder),
        )

    def _serve(self, entries: List[_Request]) -> None:
        t0 = time.perf_counter()
        try:
            arena = GraphArena([r.sample for r in entries])
            n_pad, e_pad, fallback = self._bucket_shape(
                int(arena.ns.sum()), int(arena.es.sum())
            )
            host = arena.collate(
                np.arange(len(entries)),
                num_nodes_pad=n_pad,
                num_edges_pad=e_pad,
                num_graphs_pad=self._g_pad,
                edge_dim=self._edge_dim,
            )
        except Exception as e:  # noqa: BLE001 — fails this batch only
            for req in entries:
                self._reject(req, e)
            return
        batch = GraphBatch.from_numpy(host, self.device)
        with torch.inference_mode():
            outputs = [o.cpu().numpy() for o in self.model(batch)]
        with self._lock:
            self.batches_run += 1
            self.ladder_fallbacks += int(fallback)
            self.batch_seconds.append(time.perf_counter() - t0)
        node_start = arena.node_start
        for i, req in enumerate(entries):
            per_head = []
            for ihead, htype in enumerate(self.model.output_type):
                if htype == "graph":
                    per_head.append(outputs[ihead][i])
                else:
                    lo = int(node_start[i])
                    per_head.append(outputs[ihead][lo : lo + req.sample.num_nodes])
            with self._lock:
                self._pending.discard(req.future)
            _settle(req.future, per_head)

    def _reject(self, req: _Request, exc: BaseException) -> None:
        with self._lock:
            self._pending.discard(req.future)
        _settle(req.future, exc=exc)

    def _fail_pending(self, exc: BaseException) -> None:
        with self._lock:
            pending, self._pending = self._pending, set()
        for fut in pending:
            _settle(fut, exc=exc)
