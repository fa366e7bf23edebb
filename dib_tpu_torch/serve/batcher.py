"""Bounded CONTINUOUS micro-batching in front of an :class:`InferenceEngine`
(counterpart of ``dib_tpu/serve/batcher.py``).

Concurrent requests are coalesced into padded micro-batches under two bounds:

  - ``max_batch``: dispatch as soon as this many rows are waiting;
  - ``max_wait_ms``: never hold the FIRST request of a batch longer than
    this, even at depth 1 (the latency floor a lone request pays).

Batching is **continuous**: requests keep entering the queue while an engine
dispatch runs, and the moment it returns, everything that queued up during it
forms the next batch and dispatches at once. The wait window applies only
when the engine is idle and the queue was empty.

Contracts:

  - **Semantic invisibility**: a request's result equals the one it gets
    dispatched alone, since the engine's posterior-mean forward pass is
    row-independent; the batcher only concatenates, pads and splits rows.
  - **Error isolation**: shape/width validation happens at ``submit``, and a
    batch whose dispatch still fails is retried per request so only the
    guilty request carries the error.
  - **Backpressure**: a full queue refuses new work (``QueueFullError``).
  - **Timeouts**: a request that waited past its deadline completes with
    ``RequestTimeout`` at the next drain, and its rows are never dispatched.

The JAX package's telemetry (span events, metrics registry) has no
counterpart yet: ``tracer`` and ``registry`` must be ``None``.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

__all__ = [
    "BatcherClosed",
    "MicroBatcher",
    "QueueFullError",
    "RequestTimeout",
]


class QueueFullError(RuntimeError):
    """The batcher's bounded queue refused a request (backpressure)."""


class RequestTimeout(RuntimeError):
    """The request waited past its deadline before dispatch completed."""


class BatcherClosed(RuntimeError):
    """The batcher is shut down; no new work is accepted."""


class _Request:
    """One submitted request: rows + a one-shot result slot."""

    __slots__ = ("op", "rows", "deadline", "dispatched", "_event", "_result", "_error")

    def __init__(self, op: str, rows: np.ndarray, deadline: float | None):
        self.op = op
        self.rows = rows
        self.deadline = deadline
        # flipped by the worker when the engine dispatch carrying these rows
        # starts: a timeout before that is queue wait
        self.dispatched = False
        self._event = threading.Event()
        self._result = None
        self._error = None

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: float | None = None):
        """Block for the result; raises the request's error if it failed."""
        if not self._event.wait(timeout):
            where = "in flight" if self.dispatched else "still queued"
            error = RequestTimeout(f"no result within {timeout}s (request {where})")
            error.in_queue = not self.dispatched
            raise error
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Coalesces concurrent requests into padded engine dispatches.

    Args:
      engine: an :class:`~dib_tpu_torch.serve.engine.InferenceEngine` (or any
        object with ``predict``/``encode`` taking [B, width] rows and
        returning a dict of [B, ...] arrays, plus ``feature_width`` /
        ``max_bucket``).
      max_batch: dispatch when this many ROWS are waiting (bounded by the
        engine's top bucket).
      max_wait_ms: longest the first waiting request is held for batch-mates.
      max_queue: bound on queued requests; beyond it ``submit`` raises
        :class:`QueueFullError`.
      tracer, registry: telemetry sinks of the JAX package; not ported yet,
        so only ``None`` is accepted.
    """

    def __init__(self, engine, max_batch: int = 32, max_wait_ms: float = 2.0,
                 max_queue: int = 256, tracer=None, registry=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if tracer is not None or registry is not None:
            raise NotImplementedError("batcher telemetry is not ported yet")
        self.engine = engine
        self.max_batch = min(int(max_batch), int(engine.max_bucket))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._closed = False
        # Guards the closed-check + enqueue as one step against close():
        # without it a submit that passed the check could land its request
        # in a queue whose worker already exited (stranded forever).
        self._lifecycle = threading.Lock()
        self._worker = threading.Thread(target=self._run, name="dib-serve-batcher",
                                        daemon=True)
        self._worker.start()

    # --------------------------------------------------------------- client
    def submit(self, x, op: str = "predict", timeout_s: float | None = None) -> _Request:
        """Enqueue one request; returns its future. Validation is eager: a
        malformed request never reaches a batch."""
        if self._closed:
            raise BatcherClosed("batcher is closed")
        if op not in ("predict", "encode"):
            raise ValueError(f"unknown op {op!r} (predict|encode)")
        rows = np.asarray(x, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[0] == 0:
            raise ValueError(f"expected a row or non-empty row matrix, got shape {rows.shape}")
        if rows.shape[1] != self.engine.feature_width:
            raise ValueError(
                f"expected rows of width {self.engine.feature_width}, got {rows.shape[1]}")
        if not np.all(np.isfinite(rows)):
            raise ValueError("request contains non-finite values")
        deadline = time.perf_counter() + timeout_s if timeout_s is not None else None
        request = _Request(op, rows, deadline)
        with self._lifecycle:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            try:
                self._queue.put_nowait(request)
            except queue.Full:
                raise QueueFullError(
                    f"serving queue full ({self._queue.maxsize} requests); "
                    "retry with backoff"
                ) from None
        return request

    def __call__(self, x, op: str = "predict", timeout_s: float | None = None):
        """Blocking convenience: submit + wait (client-side timeout too)."""
        return self.submit(x, op, timeout_s=timeout_s).result(timeout_s)

    def is_alive(self) -> bool:
        """False once the dispatch worker has died or the batcher was closed."""
        return self._worker.is_alive() and not self._closed

    def close(self, drain: bool = True) -> None:
        """Stop accepting work; optionally drain what is queued, then fail
        anything left with :class:`BatcherClosed`."""
        with self._lifecycle:
            self._closed = True
        if drain:
            self._worker.join(timeout=30.0)
        self._fail_queued()
        self._worker.join(timeout=5.0)
        self._fail_queued()   # nothing can enqueue after the flag; final sweep

    def _fail_queued(self) -> None:
        leftovers = []
        try:
            while True:
                leftovers.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        for request in leftovers:
            request.set_error(BatcherClosed("batcher closed before dispatch"))

    # --------------------------------------------------------------- worker
    def _collect(self, continuous: bool = False) -> list[_Request]:
        """Gather the next micro-batch.

        ``continuous=True`` means a dispatch JUST returned: whatever queued up
        during it dispatches immediately, with no wait window. When the queue
        is empty the engine is idle and the classic path applies: block for
        the first request, then hold it ``max_wait_ms`` for batch-mates.
        """
        if continuous:
            batch: list[_Request] = []
            rows = 0
            while rows < self.max_batch:
                try:
                    request = self._queue.get_nowait()
                except queue.Empty:
                    break
                batch.append(request)
                rows += request.rows.shape[0]
            if batch:
                return batch
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        rows = first.rows.shape[0]
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                request = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(request)
            rows += request.rows.shape[0]
        return batch

    def _run(self) -> None:
        just_dispatched = False
        while not (self._closed and self._queue.empty()):
            batch = self._collect(continuous=just_dispatched)
            just_dispatched = bool(batch)
            if not batch:
                continue
            now = time.perf_counter()
            live: dict[str, list[_Request]] = {}
            for request in batch:
                if request.deadline is not None and now > request.deadline:
                    error = RequestTimeout("request timed out in queue before dispatch")
                    error.in_queue = True
                    request.set_error(error)
                    continue
                live.setdefault(request.op, []).append(request)
            # one padded dispatch per op present in the drain
            for op, requests in live.items():
                self._dispatch_group(op, requests)

    def _dispatch_group(self, op: str, requests: list[_Request]) -> None:
        for request in requests:
            request.dispatched = True
        rows = np.concatenate([r.rows for r in requests])
        try:
            out = getattr(self.engine, op)(rows)
        except Exception:
            # isolation: re-run each request alone so only the guilty one
            # carries the error (a batch-mate must never fail by proximity)
            for request in requests:
                try:
                    request.set_result(getattr(self.engine, op)(request.rows))
                except Exception as exc:
                    request.set_error(exc)
            return
        offset = 0
        for request in requests:
            k = request.rows.shape[0]
            request.set_result({key: value[offset : offset + k] for key, value in out.items()})
            offset += k
