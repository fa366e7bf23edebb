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

Each request is a future: ``result`` blocks a thread, ``wait_async`` parks a
coroutine of the asyncio server, and ``add_done_callback`` wakes either. The
worker stamps ``collected`` (dequeued into a micro-batch) and
``dispatch_start`` (the engine call began) on each request, on the process-
wide ``perf_counter`` clock the server's phase clock reads. Queue depth,
batch rows and fill, the per-status request counters and the batcher-side
request latency land in an optional ``MetricsRegistry``.

Telemetry: each dispatched micro-batch lands as a ``batch`` span (op, rows,
requests, bucket, fill) and each request the server does not span itself as
a ``request`` span (op, status, rows, tenant) through an optional
``telemetry.Tracer``. A batch is timed on the host clock around the engine
call, which returns only once the result is back on the host.
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

    __slots__ = ("op", "rows", "deadline", "submitted", "dispatched",
                 "collected", "dispatch_start", "server_span", "tenant",
                 "_event", "_result", "_error", "_cb_lock", "_callbacks")

    def __init__(self, op: str, rows: np.ndarray, deadline: float | None,
                 tenant: str | None = None, server_span: bool = False):
        self.op = op
        self.rows = rows
        self.deadline = deadline
        self.tenant = tenant
        self.submitted = time.perf_counter()
        # flipped by the worker the moment the engine dispatch carrying
        # these rows starts: a timeout BEFORE that is queue wait (the
        # replica never got to show whether it is slow), after it the
        # dispatch itself missed the deadline
        self.dispatched = False
        # phase-clock stamps, written by the batcher worker and read by
        # the HTTP server AFTER the future completes (so no torn reads):
        # collected = dequeued into a micro-batch (queue wait ends),
        # dispatch_start = the engine call carrying these rows began
        # (batch-formation ends). perf_counter is process-wide, so these
        # telescope onto the server's own stamp timeline.
        self.collected = None
        self.dispatch_start = None
        # True when the HTTP front end owns the request span (it has the
        # full read→write anatomy; the batcher only sees the middle) —
        # _finish then skips span emission so each request lands exactly
        # one span, but keeps the status counters (they are the
        # authoritative "what did the batcher do" tally).
        self.server_span = server_span
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._cb_lock = threading.Lock()
        self._callbacks: list = []

    # -------------------------------------------------------------- future
    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """Call ``fn()`` (no args) when the result/error lands — from the
        completing thread, so ``fn`` must be thread-safe and cheap (the
        asyncio front end passes a ``call_soon_threadsafe`` trampoline).
        A request that is already done calls back immediately."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn()

    def _complete(self) -> None:
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn()

    def set_result(self, result) -> None:
        self._result = result
        self._complete()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._complete()

    def result(self, timeout: float | None = None):
        """Block for the result; raises the request's error if it failed."""
        if not self._event.wait(timeout):
            where = "in flight" if self.dispatched else "still queued"
            error = RequestTimeout(f"no result within {timeout}s "
                                   f"(request {where})")
            error.in_queue = not self.dispatched
            raise error
        if self._error is not None:
            raise self._error
        return self._result

    async def wait_async(self, timeout: float | None = None):
        """Awaitable twin of :meth:`result` for the asyncio server: parks
        the coroutine (never the event loop thread) until the batcher
        worker completes this request."""
        import asyncio

        loop = asyncio.get_running_loop()
        future = loop.create_future()

        def _wake():
            # completing thread -> loop thread; the future may already be
            # cancelled by wait_for's timeout, or the loop itself torn
            # down (a shutdown racing the completion)
            try:
                loop.call_soon_threadsafe(
                    lambda: future.done() or future.set_result(None))
            except RuntimeError:
                pass

        self.add_done_callback(_wake)
        try:
            await asyncio.wait_for(future, timeout)
        except asyncio.TimeoutError:
            where = "in flight" if self.dispatched else "still queued"
            error = RequestTimeout(f"no result within {timeout}s "
                                   f"(request {where})")
            error.in_queue = not self.dispatched
            raise error from None
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Coalesces concurrent requests into padded engine dispatches.

    Args:
      engine: an :class:`~dib_tpu_torch.serve.engine.InferenceEngine` (or any
        object with ``predict``/``encode`` taking [B, width] rows and
        returning a dict of [B, ...] arrays, plus ``feature_width`` /
        ``max_bucket`` / ``bucket_for``).
      max_batch: dispatch when this many ROWS are waiting (bounded by the
        engine's top bucket — a larger value would always chunk).
      max_wait_ms: longest the first waiting request is held for
        batch-mates before dispatching whatever is there.
      max_queue: bound on queued requests; beyond it ``submit`` raises
        :class:`QueueFullError`.
      tracer: optional ``telemetry.Tracer`` for ``batch``/``request`` span
        events.
      registry: optional ``MetricsRegistry`` for queue/latency metrics.
    """

    def __init__(
        self,
        engine,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        max_queue: int = 256,
        tracer=None,
        registry=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.max_batch = min(int(max_batch), int(engine.max_bucket))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.registry = registry
        self.tracer = tracer
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._closed = False
        # Guards the closed-check + enqueue as one step against close():
        # without it a submit that passed the check could land its request
        # in a queue whose worker already exited (stranded forever).
        self._lifecycle = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="dib-serve-batcher", daemon=True
        )
        self._worker.start()

    # --------------------------------------------------------------- client
    def submit(self, x, op: str = "predict",
               timeout_s: float | None = None,
               tenant: str | None = None,
               server_span: bool = False) -> _Request:
        """Enqueue one request; returns its future. Validation is eager —
        a malformed request never reaches a batch. ``tenant`` is an
        optional label carried onto the request's span event.
        ``server_span=True`` hands request-span ownership to the caller
        (the asyncio server's phase clock) — must be set HERE, at
        construction, because a fast dispatch can ``_finish`` before
        ``submit`` even returns."""
        if self._closed:
            raise BatcherClosed("batcher is closed")
        if op not in ("predict", "encode"):
            raise ValueError(f"unknown op {op!r} (predict|encode)")
        rows = np.asarray(x, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[0] == 0:
            raise ValueError(
                f"expected a row or non-empty row matrix, got shape {rows.shape}"
            )
        if rows.shape[1] != self.engine.feature_width:
            raise ValueError(
                f"expected rows of width {self.engine.feature_width}, "
                f"got {rows.shape[1]}"
            )
        if not np.all(np.isfinite(rows)):
            raise ValueError("request contains non-finite values")
        deadline = (
            time.perf_counter() + timeout_s if timeout_s is not None else None
        )
        request = _Request(op, rows, deadline, tenant=tenant,
                           server_span=server_span)
        with self._lifecycle:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            try:
                self._queue.put_nowait(request)
            except queue.Full:
                # shed load VISIBLY: without this counter an overloaded
                # server's rollup shows only the requests it accepted
                if self.registry is not None:
                    self.registry.counter("serve.requests.rejected").inc()
                raise QueueFullError(
                    f"serving queue full ({self._queue.maxsize} requests); "
                    "retry with backoff"
                ) from None
        if self.registry is not None:
            self.registry.gauge("serve.queue_depth").set(self._queue.qsize())
        return request

    def __call__(self, x, op: str = "predict",
                 timeout_s: float | None = None):
        """Blocking convenience: submit + wait (client-side timeout too)."""
        return self.submit(x, op, timeout_s=timeout_s).result(timeout_s)

    def is_alive(self) -> bool:
        """Liveness of the dispatch worker: False once the thread has died
        (an escaped exception) or the batcher was closed. The truthful
        ``/healthz`` keys on this — a process whose batcher thread is dead
        accepts requests into a queue nothing will ever drain."""
        return self._worker.is_alive() and not self._closed

    def revive(self) -> bool:
        """Restart a DEAD dispatch worker (never a closed batcher).

        The self-healing path for an escaped exception having killed the
        drain loop: queued requests survive in the queue, and the fresh
        worker resumes draining them. Returns True when a new worker was
        actually started. The router's maintenance loop calls this
        (``ReplicaRouter.probe_ejected``), emitting a ``mitigation`` event
        per revival."""
        with self._lifecycle:
            if self._closed or self._worker.is_alive():
                return False
            self._worker = threading.Thread(
                target=self._run, name="dib-serve-batcher", daemon=True
            )
            self._worker.start()
            return True

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

        ``continuous=True`` means an engine dispatch JUST returned: if
        anything queued up during it, it dispatches immediately — drained
        without blocking, no ``max_wait_ms`` window (those requests
        already waited out a whole dispatch; holding the now-idle engine
        for batch-mates would only add latency under load). When the
        queue is empty at return time the engine is genuinely idle and
        the classic path applies: block for the first request, then hold
        it ``max_wait_ms`` for batch-mates (the depth-1 latency floor).
        """
        if continuous:
            batch: list[_Request] = []
            rows = 0
            while rows < self.max_batch:
                try:
                    request = self._queue.get_nowait()
                except queue.Empty:
                    break
                request.collected = time.perf_counter()
                batch.append(request)
                rows += request.rows.shape[0]
            if batch:
                return batch
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        first.collected = time.perf_counter()
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
            request.collected = time.perf_counter()
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
            if self.registry is not None:
                self.registry.gauge("serve.queue_depth").set(
                    self._queue.qsize()
                )
            now = time.perf_counter()
            live: dict[str, list[_Request]] = {}
            for request in batch:
                if request.deadline is not None and now > request.deadline:
                    error = RequestTimeout(
                        "request timed out in queue before dispatch"
                    )
                    # queue expiry is backpressure, not replica sickness —
                    # the server's health accounting keys on this flag
                    error.in_queue = True
                    request.set_error(error)
                    self._finish(request, "timeout", now)
                    continue
                live.setdefault(request.op, []).append(request)
            # one padded dispatch per op present in the drain — ops cannot
            # share an executable, but a mixed drain still empties fully
            for op, requests in live.items():
                self._dispatch_group(op, requests)

    def _capacity(self, n: int) -> int:
        """Total padded rows the engine allocates for ``n`` requested rows —
        the denominator of an honest fill ratio even when the dispatch
        chunks at the top bucket (fill must never exceed 1)."""
        capacity, remaining = 0, n
        while remaining > 0:
            take = min(remaining, self.engine.max_bucket)
            capacity += self.engine.bucket_for(take)
            remaining -= take
        return capacity

    def _dispatch_group(self, op: str, requests: list[_Request]) -> None:
        group_t0 = time.perf_counter()
        for request in requests:
            request.dispatched = True
            request.dispatch_start = group_t0
        rows = np.concatenate([r.rows for r in requests])
        n = rows.shape[0]
        t0 = time.perf_counter()
        try:
            out = getattr(self.engine, op)(rows)
        except Exception:
            # isolation: re-run each request alone so only the guilty one
            # carries the error (a batch-mate must never fail by proximity)
            for request in requests:
                try:
                    result = getattr(self.engine, op)(request.rows)
                    request.set_result(result)
                    self._finish(request, "ok", time.perf_counter())
                except Exception as exc:
                    request.set_error(exc)
                    self._finish(request, "error", time.perf_counter())
            return
        done = time.perf_counter()
        seconds = done - t0
        offset = 0
        for request in requests:
            k = request.rows.shape[0]
            request.set_result(
                {key: value[offset : offset + k]
                 for key, value in out.items()}
            )
            offset += k
            self._finish(request, "ok", done)
        if self.tracer is None and self.registry is None:
            return
        fill = n / self._capacity(n)
        if self.tracer is not None:
            bucket = (self.engine.bucket_for(n)
                      if n <= self.engine.max_bucket else self.engine.max_bucket)
            self.tracer.add("batch", seconds, op=op, rows=n, requests=len(requests),
                            bucket=bucket, fill=round(fill, 4))
        if self.registry is not None:
            self.registry.counter("serve.batches").inc()
            self.registry.histogram("serve.batch_rows").record(n)
            self.registry.histogram("serve.batch_fill").record(fill)

    def _finish(self, request: _Request, status: str, now: float) -> None:
        latency = now - request.submitted
        if self.tracer is not None and not request.server_span:
            tags = {}
            if request.tenant is not None:
                tags["tenant"] = request.tenant
            self.tracer.add("request", latency, op=request.op, status=status,
                            rows=int(request.rows.shape[0]), **tags)
        if self.registry is not None:
            self.registry.counter(f"serve.requests.{status}").inc()
            if not request.server_span:
                # server_span requests get their END-TO-END latency
                # recorded by the HTTP server instead — recording the
                # batcher-interior slice too would double count
                self.registry.histogram(
                    "serve.request_latency_s").record(latency)
