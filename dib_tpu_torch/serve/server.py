"""Asyncio event-loop JSON HTTP front end over a model zoo
(counterpart of ``dib_tpu/serve/server.py``).

The whole HTTP surface runs on ONE event loop in a thread of its own:
connections are coroutines, a request coroutine parks on the batcher's
completion callback (never a thread), and the only other threads are the
per-replica batcher workers (which spend their lives in the engine's
forward pass, or waiting on a pool worker's pipe).

Routes:

  - ``POST /v1/predict``  ``{"x": row | rows, "beta"?: float,
    "model"?: name, "tenant"?: id, "timeout_s"?: float}`` →
    posterior-mean predictions + per-example per-channel KL (nats) from
    the routed replica of the selected zoo model.
  - ``POST /v1/encode``   same request shape → per-feature Gaussian
    channel parameters (``mus``/``logvars``).
  - ``GET  /v1/models``   the zoo registry: every served checkpoint, its
    replica count, β labels, reload count.
  - ``GET  /healthz``     liveness + the serving surface (feature width,
    buckets, per-model replica health).
  - ``GET  /metrics``     the ``MetricsRegistry`` snapshot as JSON (with the
    answering process's ``pid`` and its kernel launch counts), or
    Prometheus text under content negotiation (``Accept: text/plain`` /
    ``?format=prometheus``).

Status mapping: client errors (shape/width/non-finite payloads, unknown
model or route) are 400/404; queue backpressure and admission-control
shedding are 503 with ``Retry-After``; a tenant over its token-bucket quota
is **429** with ``Retry-After`` (the refill horizon); a request timeout is
504; everything else is 500. Errors are isolated per request.

Multi-tenancy: requests carry a tenant id (``X-DIB-Tenant`` header or
``"tenant"`` body field; absent → ``"anonymous"``). Admission control bounds
TOTAL in-flight requests (``admission_limit``), and per-tenant token buckets
(:class:`TenantQuotas`) bound each tenant's sustained rate + burst. Both
rejections count (``serve.requests.quota`` / ``serve.requests.shed``).

Caching: when the zoo carries a ``ResponseCache``, a repeated ``(input, β,
checkpoint)`` query is answered straight from the loop thread (no queue, no
dispatch) and marked ``"cached": true``.

Self-healing: an engine-side dispatch failure marks the replica
(``router.report_failure``) and the request RETRIES on another healthy
replica under one deadline. ``/healthz`` is truthful: 503 with a JSON
detail when no replica can carry a request, 200 otherwise.

Request anatomy: every request through the op routes carries a
:class:`_PhaseClock`, an ordered sequence of ``perf_counter`` stamps at read
(headers+body), parse (JSON decode), admission (quota + shed checks), queue
(batcher wait), batch (micro-batch formation), dispatch (engine execution +
loop wake), serialize (``json.dumps``) and write (socket drain); the phases
telescope to the request's seconds exactly. After the socket write the
server records each phase in ``serve.phase.<name>`` and the end-to-end time
in ``serve.request_latency_s`` (fleet-mergeable bucket counts on
``/metrics``; see ``python -m dib_tpu_torch serve top``).

Telemetry: the server owns the run bracket's end (the CLI writes the
``run_start`` manifest with ``mode: "serve"``; ``close()`` writes the final
``metrics`` rollup and then ``run_end``), so a serving run directory
summarizes and renders with ``python -m dib_tpu_torch telemetry
summarize|report`` like a training run. Each request through the op routes
lands as ONE ``request`` span, written by the server after the socket write,
with a ``phases`` field whose values telescope to the span's ``seconds``;
the batcher suppresses its own span for these (``server_span=True``).
``batch`` spans are the batcher's: one per padded engine dispatch. Health
transitions land as one ``mitigation`` event per edge
(``serving_unhealthy``/``serving_recovered``).
"""

from __future__ import annotations

import asyncio
import json
import math
import socket
import threading
import time

import numpy as np

from dib_tpu_torch.serve.batcher import BatcherClosed, QueueFullError, RequestTimeout
from dib_tpu_torch.serve.replicas import NoHealthyReplicaError
from dib_tpu_torch.serve.zoo import ModelZoo, response_key
from dib_tpu_torch.telemetry.metrics import prometheus_text

__all__ = ["DIBServer", "TenantQuotas"]

_DEFAULT_REQUEST_TIMEOUT_S = 30.0
_MAX_BODY_BYTES = 8 << 20   # 8 MiB: ~1M f32 features as JSON text
_IDLE_KEEPALIVE_S = 120.0   # reap silent keep-alive sockets
_OPS = {"/v1/predict": "predict", "/v1/encode": "encode"}


class _PhaseClock:
    """Ordered monotonic stamp sequence for ONE HTTP request.

    ``stamps`` is ``[(phase_name, perf_counter), ...]`` starting at the
    request line's arrival; phases are the diffs of consecutive stamps,
    each named by its LATER stamp (``phases()``), so they telescope to
    exactly last-minus-first — the span's ``seconds`` — by construction.
    Repeated names accumulate (a replica retry re-traverses
    queue/batch/dispatch and each traversal adds to its phase).

    ``meta`` is the span payload (status/op/rows/tenant/cached) or None —
    None means this request writes NO span and records nothing (400/404,
    queue-full and no-replica 503s).
    """

    __slots__ = ("stamps", "meta")

    def __init__(self, t0: float):
        self.stamps: list[tuple[str, float]] = [("t0", t0)]
        self.meta: dict | None = None

    def stamp(self, name: str, t: float | None = None) -> None:
        if t is None:
            t = time.perf_counter()
        # clamp: batcher-thread stamps sampled from request attributes can
        # race a few ns behind the loop's own last stamp; clamping keeps
        # every phase >= 0 without disturbing the telescoped total
        prev = self.stamps[-1][1]
        self.stamps.append((name, t if t > prev else prev))

    def phases(self) -> dict[str, float]:
        out: dict[str, float] = {}
        prev = self.stamps[0][1]
        for name, t in self.stamps[1:]:
            out[name] = out.get(name, 0.0) + (t - prev)
            prev = t
        return out

    def elapsed(self) -> float:
        return self.stamps[-1][1] - self.stamps[0][1]


def _kernel_launches() -> dict:
    """This process's launch counts of the port's hand-written kernels
    (``/metrics`` carries them beside ``pid``, so that ``chip_smoke.py``
    reads what each serving process launched; serving itself runs none)."""
    from dib_tpu_torch.ops import attention, density

    return {name: getattr(module, f"{name}_launches")
            for module, names in ((density, ("mi_row_stats", "log_density_mat")),
                                  (attention, ("flash_attention",
                                               "flash_attention_bf16")))
            for name in names}


class TenantQuotas:
    """Per-tenant token buckets: ``rate`` requests/s sustained with
    ``burst`` headroom; a tenant over budget is refused with the seconds
    until its next token (the 429's ``Retry-After``).

    ``overrides`` maps tenant ids to ``(rate, burst)`` pairs for tiered
    tenants. A rate of 0 disables quota enforcement entirely (the
    single-tenant dev default).

    Tenant ids are CLIENT-CONTROLLED (a header), so the bucket map is
    bounded: past ``max_tenants`` live buckets, a sweep drops every
    bucket that has refilled to full — a full bucket is exactly the
    default state ``admit`` reconstructs, so eviction never changes any
    tenant's observable quota. A flood of unique throwaway ids therefore
    cannot grow the long-lived serving process without bound.
    """

    def __init__(self, rate: float, burst: float | None = None,
                 overrides: dict[str, tuple[float, float]] | None = None,
                 max_tenants: int = 10_000):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self.overrides = dict(overrides or {})
        self.max_tenants = int(max_tenants)
        self._buckets: dict[str, list[float]] = {}   # tenant -> [tokens, stamp]
        self._lock = threading.Lock()

    def limits(self, tenant: str) -> tuple[float, float]:
        return self.overrides.get(tenant, (self.rate, self.burst))

    def _prune_locked(self, now: float) -> None:
        def refilled(t: str) -> float:
            tokens, stamp = self._buckets[t]
            rate, burst = self.limits(t)
            return min(burst, tokens + (now - stamp) * rate)

        full = [t for t in self._buckets
                if refilled(t) >= self.limits(t)[1]]
        for t in full:
            del self._buckets[t]
        # still over budget with every bucket draining: evict the FULLEST
        # buckets — eviction resets a bucket to full, so the fullest have
        # the smallest token error, and a flood of throwaway ids (each
        # having burned one token of a fresh burst) evicts its own
        # near-full residue, never a genuinely throttled tenant near zero
        while len(self._buckets) >= self.max_tenants:
            fullest = max(self._buckets, key=refilled)
            del self._buckets[fullest]

    def admit(self, tenant: str) -> float:
        """0.0 when the request is admitted (one token burned), else the
        seconds until the tenant's bucket refills one token."""
        rate, burst = self.limits(tenant)
        if rate <= 0:
            return 0.0
        now = time.monotonic()
        with self._lock:
            if (tenant not in self._buckets
                    and len(self._buckets) >= self.max_tenants):
                self._prune_locked(now)
            tokens, stamp = self._buckets.get(tenant, (burst, now))
            tokens = min(burst, tokens + (now - stamp) * rate)
            if tokens >= 1.0:
                self._buckets[tenant] = [tokens - 1.0, now]
                return 0.0
            self._buckets[tenant] = [tokens, now]
            return (1.0 - tokens) / rate


class DIBServer:
    """Owns the asyncio HTTP listener, the model zoo and the end of the
    run's telemetry bracket.

    ``router`` may be a ``ReplicaRouter`` (wrapped as a single-model zoo)
    or a :class:`~dib_tpu_torch.serve.zoo.ModelZoo`. ``port=0`` binds an
    ephemeral port; the bound port is ``self.port``. ``start()`` runs the
    event loop in a daemon thread; ``close()`` stops the loop, drains the
    batchers, writes the final metrics rollup + ``run_end`` and releases
    the socket — safe to call twice (signal handler + finally).
    ``reuse_port=True`` binds with ``SO_REUSEPORT``, the prefork request
    plane (``serve/prefork.py``): sibling server processes listen on one
    port and the kernel balances connections across them.
    ``telemetry`` is the run's ``EventWriter``; with it and no ``tracer``
    the server makes a ``Tracer`` of its own for the request spans.
    """

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0,
                 telemetry=None, registry=None, tracer=None,
                 quotas: TenantQuotas | None = None,
                 admission_limit: int | None = None,
                 reuse_port: bool = False):
        self.zoo = (router if isinstance(router, ModelZoo)
                    else ModelZoo.single(router, telemetry=telemetry,
                                         registry=registry))
        self.telemetry = telemetry
        self.registry = registry
        if tracer is None and telemetry is not None:
            # the server owns the request span (it has the whole read ->
            # write anatomy; the batcher suppresses its own), so it must be
            # able to write it when the caller wired no tracer
            from dib_tpu_torch.telemetry.trace import Tracer

            tracer = Tracer(telemetry)
        self.tracer = tracer
        self.quotas = quotas
        self.admission_limit = (int(admission_limit)
                                if admission_limit else None)
        self._inflight = 0                      # loop-thread only
        self._closed = threading.Lock()
        self._done = False
        self._health_lock = threading.Lock()
        self._was_serviceable = True   # /healthz transition edge detector
        # Bind synchronously so self.port exists before start() — callers
        # (CLI, tests) read it right after construction.
        self._sock = socket.create_server((host, port), backlog=512,
                                          reuse_port=reuse_port)
        self._sock.setblocking(False)
        self.host, self.port = self._sock.getsockname()[:2]
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop: asyncio.Event | None = None
        self._prev_switch_interval: float | None = None
        self._prev_gc_threshold: tuple | None = None
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run_loop, name="dib-serve-loop", daemon=True,
        )

    # ------------------------------------------------------------ lifecycle
    @property
    def router(self):
        """The default model's router (single-model compatibility)."""
        _, router = self.zoo.resolve(None)
        return router

    def start(self) -> "DIBServer":
        # A serving process is a latency-critical multi-threaded process:
        # the event loop and the batcher workers hand requests to each
        # other through locks/futures, and CPython's default 5 ms GIL
        # switch interval turns every contested handoff into a
        # milliseconds-scale stall. 1 ms costs negligible switching
        # overhead at serving thread counts; close() restores the old value
        # so test processes are left as found.
        import sys as _sys

        self._prev_switch_interval = _sys.getswitchinterval()
        _sys.setswitchinterval(0.001)
        # Same latency argument for the cyclic GC: the serving hot path
        # frees everything by refcount (request dicts, futures, numpy
        # views), so gen-0 sweeps at the default 700-allocation threshold
        # only add multi-ms pauses at four-figure req/s. Freeze the boot
        # object graph out of collection and collect ~100x less often;
        # close() restores the thresholds.
        import gc as _gc

        self._prev_gc_threshold = _gc.get_threshold()
        _gc.freeze()
        _gc.set_threshold(70_000, 50, 50)
        self._thread.start()
        self._ready.wait(timeout=30.0)
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _run_loop(self) -> None:
        asyncio.run(self._amain())

    async def _amain(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(self._handle_conn,
                                            sock=self._sock)
        self._ready.set()
        try:
            await self._stop.wait()
        finally:
            server.close()
            await server.wait_closed()

    def close(self) -> None:
        with self._closed:
            if self._done:
                return
            self._done = True
        if self._loop is not None and self._stop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:   # loop already gone
                pass
        if self._thread.ident is not None:
            self._thread.join(timeout=10.0)
        if getattr(self, "_prev_switch_interval", None) is not None:
            import sys as _sys

            _sys.setswitchinterval(self._prev_switch_interval)
        if getattr(self, "_prev_gc_threshold", None) is not None:
            import gc as _gc

            _gc.set_threshold(*self._prev_gc_threshold)
            _gc.unfreeze()
        if not self._ready.is_set():
            # start() was never called: release the bound socket directly
            self._sock.close()
        self.zoo.close()
        if self.telemetry is not None:
            if self.registry is not None:
                from dib_tpu_torch.telemetry.metrics import write_metrics

                write_metrics(self.registry, self.telemetry)
            self.telemetry.run_end(status="ok")
            self.telemetry.close()

    # ------------------------------------------------------ HTTP plumbing
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """One keep-alive connection: parse requests until the client
        hangs up; a handler bug answers 500, never kills the loop."""
        try:
            while True:
                try:
                    request_line = await asyncio.wait_for(
                        reader.readline(), timeout=_IDLE_KEEPALIVE_S)
                except asyncio.TimeoutError:
                    break
                if not request_line or request_line in (b"\r\n", b"\n"):
                    break
                try:
                    method, path, _ = request_line.decode(
                        "latin-1").split(None, 2)
                except ValueError:
                    await self._reply(writer, 400,
                                      {"error": "malformed request line"},
                                      close=True)
                    break
                clock = (_PhaseClock(time.perf_counter())
                         if method == "POST" and path in _OPS else None)
                headers = await self._read_headers(reader)
                if headers is None:
                    break
                keep_alive = headers.get("connection", "").lower() != "close"
                try:
                    length = int(headers.get("content-length") or 0)
                except ValueError:
                    # a malformed length leaves the body unreadable, so
                    # the socket cannot be resynchronized: answer and drop
                    await self._reply(writer, 400,
                                      {"error": "malformed Content-Length"},
                                      close=True)
                    break
                if length > _MAX_BODY_BYTES:
                    # the unread body would desync the keep-alive socket
                    # (its bytes become the "next request"): drop it
                    await self._reply(writer, 413,
                                      {"error": "request body too large"},
                                      close=True)
                    break
                body = await reader.readexactly(length) if length else b""
                if clock is not None:
                    clock.stamp("read")
                try:
                    status, payload, extra_headers = await self._dispatch(
                        method, path, headers, body, clock)
                except Exception as exc:   # never let a bug kill the socket
                    if clock is not None:
                        clock.meta = None   # escaped bugs never emitted spans
                    status, payload, extra_headers = 500, {
                        "error": f"{type(exc).__name__}: {exc}"}, {}
                if isinstance(payload, str):
                    await self._reply_text(writer, status, payload,
                                           extra_headers,
                                           close=not keep_alive)
                else:
                    await self._reply(writer, status, payload,
                                      headers=extra_headers,
                                      close=not keep_alive, clock=clock)
                    if clock is not None:
                        self._finalize_request(clock)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    @staticmethod
    async def _read_headers(reader) -> dict | None:
        headers: dict[str, str] = {}
        while True:
            line = await reader.readline()
            if not line:
                return None
            if line in (b"\r\n", b"\n"):
                return headers
            key, sep, value = line.decode("latin-1").partition(":")
            if sep:
                headers[key.strip().lower()] = value.strip()

    async def _reply(self, writer, status: int, payload: dict,
                     headers: dict | None = None,
                     close: bool = False, clock=None) -> None:
        blob = json.dumps(payload).encode()
        if clock is not None:
            clock.stamp("serialize")
        await self._write_response(
            writer, status, blob, "application/json", headers, close, clock)

    async def _reply_text(self, writer, status: int, text: str,
                          headers: dict | None = None,
                          close: bool = False) -> None:
        await self._write_response(
            writer, status, text.encode(),
            "text/plain; version=0.0.4; charset=utf-8", headers, close)

    @staticmethod
    async def _write_response(writer, status: int, blob: bytes,
                              content_type: str, headers: dict | None,
                              close: bool, clock=None) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large", 429: "Too Many Requests",
                  500: "Internal Server Error", 503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(status, "Status")
        head = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(blob)}"]
        headers = dict(headers or {})
        if status in (503, 429) and "Retry-After" not in headers:
            headers["Retry-After"] = "1"
        for key, value in headers.items():
            head.append(f"{key}: {value}")
        if close:
            head.append("Connection: close")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + blob)
        await writer.drain()
        if clock is not None:
            clock.stamp("write")

    # ----------------------------------------------------------- app logic
    async def _dispatch(self, method: str, path: str, headers: dict,
                        body: bytes, clock=None):
        """(status, payload | prometheus text, extra headers) for one
        parsed request."""
        if method == "GET":
            bare = path.partition("?")[0]
            if bare == "/metrics" and self.wants_prometheus(
                    path, headers.get("accept")):
                return 200, self.metrics_text(), {}
            status, payload = self.handle_get(path)
            return status, payload, {}
        if method != "POST":
            return 404, {"error": f"no route for method {method!r}"}, {}
        try:
            parsed = json.loads(body or b"{}")
        except json.JSONDecodeError as exc:
            return 400, {"error": f"invalid JSON: {exc}"}, {}
        tenant = headers.get("x-dib-tenant") \
            or (parsed.get("tenant") if isinstance(parsed, dict) else None)
        if clock is not None:
            clock.stamp("parse")
        status, payload, extra = await self.handle_post_async(
            path, parsed, tenant=tenant, clock=clock)
        return status, payload, extra

    def metrics_text(self) -> str:
        """The registry snapshot in Prometheus text exposition format."""
        return prometheus_text(
            self.registry.snapshot() if self.registry is not None else {})

    @staticmethod
    def wants_prometheus(path: str, accept: str | None) -> bool:
        """Content negotiation for /metrics: an explicit
        ``?format=prometheus`` (or ``format=text``), or an Accept header
        that prefers ``text/plain`` (Prometheus scrapers send
        ``text/plain;version=0.0.4``) over JSON."""
        query = path.partition("?")[2]
        for pair in query.split("&"):
            key, _, value = pair.partition("=")
            if key == "format":
                return value in ("prometheus", "text")
        accept = (accept or "").lower()
        return ("text/plain" in accept or "openmetrics" in accept) \
            and "application/json" not in accept

    def _zoo_health(self) -> dict:
        """Aggregate health across every zoo model (a single-model zoo's
        payload has no per-model block)."""
        models = {}
        healthy = ejected = batchers_dead = 0
        serviceable = True
        for name in self.zoo.names():
            _, router = self.zoo.resolve(name)
            health = router.health()
            models[name] = health
            healthy += health["healthy"]
            ejected += health["ejected"]
            batchers_dead += health["batchers_dead"]
            # every served model must be able to carry a request — a zoo
            # with one dead model IS a degraded deployment
            serviceable = serviceable and health["healthy"] > 0
        first = next(iter(models.values())) if models else {"replicas": []}
        return {
            "replicas": first["replicas"],
            "models": models,
            "healthy": healthy,
            "ejected": ejected,
            "batchers_dead": batchers_dead,
            "serviceable": serviceable,
        }

    def handle_get(self, path: str) -> tuple[int, dict]:
        path = path.partition("?")[0]
        if path == "/healthz":
            entry = self.router.entries[0]
            health = self._zoo_health()
            # derived from the SAME snapshot as the payload rows (a second
            # router scan could disagree under a concurrent transition)
            serviceable = health["serviceable"]
            self._note_health_transition(serviceable, health)
            payload = {
                # the serving surface stays present even when degraded: a
                # load generator shaping traffic needs it either way
                "status": "ok" if serviceable else "unhealthy",
                "feature_width": entry.engine.feature_width,
                "num_features": entry.engine.num_features,
                "buckets": list(entry.engine.buckets),
                "replicas": health["replicas"],
                "healthy_replicas": health["healthy"],
            }
            if len(health["models"]) > 1:
                payload["models"] = {
                    name: {"healthy": h["healthy"],
                           "replicas": len(h["replicas"])}
                    for name, h in health["models"].items()
                }
            if not serviceable:
                payload["detail"] = self._unhealthy_detail(health)
            return (200 if serviceable else 503), payload
        if path == "/v1/models":
            return 200, {"models": self.zoo.describe(),
                         "cache": self.zoo.cache_stats()}
        if path == "/metrics":
            import os as _os

            # pid identifies WHICH process answered: under the prefork
            # plane every worker keeps its own registry and the kernel
            # routes each scrape to one of them — a consumer aggregating
            # fleet-wide counters needs the sample's identity
            snapshot = (self.registry.snapshot()
                        if self.registry is not None else {})
            return 200, {"pid": _os.getpid(),
                         "kernel_launches": _kernel_launches(), **snapshot}
        return 404, {"error": f"no route {path!r}"}

    @staticmethod
    def _unhealthy_detail(health: dict) -> str:
        parts = []
        if health["ejected"]:
            parts.append(f"{health['ejected']} replica(s) ejected after "
                         "consecutive dispatch failures")
        if health["batchers_dead"]:
            parts.append(f"{health['batchers_dead']} batcher worker "
                         "thread(s) dead")
        dead_models = [name for name, h in health.get("models", {}).items()
                       if h["healthy"] == 0]
        if dead_models and len(health.get("models", {})) > 1:
            parts.append(f"model(s) with no healthy replica: {dead_models}")
        return ("no replica can carry a request: "
                + "; ".join(parts or ["unknown cause"]))

    def _note_health_transition(self, serviceable: bool, health: dict) -> None:
        """One mitigation event per health EDGE (not per poll): a drill's
        detection of a dead batcher or a total ejection lands on the same
        stream as the fault that caused it."""
        with self._health_lock:
            changed = serviceable != self._was_serviceable
            self._was_serviceable = serviceable
        if changed and self.telemetry is not None:
            if serviceable:
                self.telemetry.mitigation(mtype="serving_recovered",
                                          healthy=health["healthy"])
            else:
                self.telemetry.mitigation(
                    mtype="serving_unhealthy",
                    detail=self._unhealthy_detail(health),
                    ejected=health["ejected"],
                    batchers_dead=health["batchers_dead"],
                )

    # -------------------------------------------------------------- serving
    def _span(self, status: str, op: str, rows: int, seconds: float,
              tenant: str | None, cached: bool = False) -> None:
        """A server-side ``request`` span for a request the batcher never
        saw (quota or shed rejections, cache hits) and no phase clock
        carries: seconds = submit -> completion."""
        if self.tracer is None:
            return
        tags: dict = {}
        if tenant is not None:
            tags["tenant"] = tenant
        if cached:
            tags["cached"] = True
        self.tracer.add("request", seconds, op=op, status=status, rows=rows, **tags)

    def handle_post(self, path: str, body: dict,
                    tenant: str | None = None) -> tuple[int, dict]:
        """Synchronous facade over :meth:`handle_post_async` (drills and
        tests drive the app logic without a socket). Runs the coroutine
        on the server's own loop when it is up, else on a throwaway one."""
        if self._loop is not None and self._loop.is_running():
            future = asyncio.run_coroutine_threadsafe(
                self.handle_post_async(path, body, tenant=tenant),
                self._loop)
            status, payload, _ = future.result()
            return status, payload
        status, payload, _ = asyncio.run(
            self.handle_post_async(path, body, tenant=tenant))
        return status, payload

    def _finalize_request(self, clock: _PhaseClock) -> None:
        """Write the end-to-end request span (with its ``phases``) and
        record the per-phase and end-to-end histograms — called by the
        connection loop AFTER the socket write, so every phase including
        ``write`` is on the span. ``meta is None`` (400/404, queue-full and
        no-replica 503s) writes and records nothing."""
        meta = clock.meta
        if meta is None:
            return
        phases = clock.phases()
        seconds = clock.elapsed()
        if self.registry is not None:
            if meta["status"] in ("ok", "error", "timeout") \
                    and not meta.get("cached"):
                # same population the batcher used to record (requests
                # that entered it), but now END-TO-END read->write
                self.registry.histogram(
                    "serve.request_latency_s").record(seconds)
            for name, dt in phases.items():
                self.registry.histogram(f"serve.phase.{name}").record(dt)
        if self.tracer is not None:
            tags: dict = {}
            if meta.get("tenant") is not None:
                tags["tenant"] = meta["tenant"]
            if meta.get("cached"):
                tags["cached"] = True
            self.tracer.add(
                "request", seconds, op=meta["op"], status=meta["status"],
                rows=int(meta["rows"]),
                phases={k: round(v, 9) for k, v in phases.items()}, **tags)

    async def handle_post_async(
            self, path: str, body: dict,
            tenant: str | None = None,
            clock: _PhaseClock | None = None) -> tuple[int, dict, dict]:
        op = _OPS.get(path)
        if op is None:
            return 404, {"error": f"no route {path!r}"}, {}
        if not isinstance(body, dict) or "x" not in body:
            return 400, {"error": 'request body must be {"x": row | rows}'}, {}
        beta = body.get("beta")
        if beta is not None and not isinstance(beta, (int, float)):
            return 400, {"error": '"beta" must be a number'}, {}
        timeout_s = body.get("timeout_s", _DEFAULT_REQUEST_TIMEOUT_S)
        try:
            deadline = time.monotonic() + float(timeout_s)
        except (TypeError, ValueError):
            return 400, {"error": '"timeout_s" must be a number'}, {}
        tenant = tenant if tenant is not None else "anonymous"
        t0 = time.monotonic()

        # ---- admission: per-tenant quota, then global in-flight bound.
        # Both fire BEFORE any queueing — a rejected request must cost the
        # server (and the batchers) nothing.
        if self.quotas is not None:
            retry_after = self.quotas.admit(tenant)
            if retry_after > 0:
                if self.registry is not None:
                    self.registry.counter("serve.requests.quota").inc()
                if clock is not None:
                    clock.stamp("admission")
                    clock.meta = {"status": "quota", "op": op, "rows": 0,
                                  "tenant": tenant}
                else:
                    self._span("quota", op, 0, time.monotonic() - t0, tenant)
                return 429, {
                    "error": f"tenant {tenant!r} is over its request "
                             "quota; retry after the indicated backoff",
                    "tenant": tenant,
                    "retry_after_s": round(retry_after, 3),
                }, {"Retry-After": str(max(1, math.ceil(retry_after)))}
        if self.admission_limit is not None \
                and self._inflight >= self.admission_limit:
            if self.registry is not None:
                self.registry.counter("serve.requests.shed").inc()
            if clock is not None:
                clock.stamp("admission")
                clock.meta = {"status": "shed", "op": op, "rows": 0,
                              "tenant": tenant}
            else:
                self._span("shed", op, 0, time.monotonic() - t0, tenant)
            return 503, {
                "error": f"admission limit ({self.admission_limit} "
                         "in-flight requests) reached; retry with backoff",
            }, {}
        if clock is not None:
            # admission passed — everything from here to the batcher's
            # queue pickup (model/cache resolution, submit) is "admission"
            # only up to this stamp; cache hits charge resolution+lookup
            # to "dispatch", queued requests to "queue"
            clock.stamp("admission")

        # ---- model + cache resolution
        try:
            model_name, router = self.zoo.resolve(body.get("model"))
        except KeyError as exc:
            return 404, {"error": str(exc)}, {}
        cache = self.zoo.response_cache
        cache_key = None
        if cache is not None:
            try:
                rows = np.asarray(body["x"], np.float32)
            except (TypeError, ValueError) as exc:
                return 400, {"error": f"bad input rows: {exc}"}, {}
            cache_key = response_key(model_name, op, beta, rows)
            hit = cache.get(cache_key)
            if hit is not None:
                payload = {key: np.asarray(value).tolist()
                           for key, value in hit.items()}
                payload["model"] = model_name
                payload["cached"] = True
                n = int(rows.shape[0]) if rows.ndim == 2 else 1
                if clock is not None:
                    clock.stamp("dispatch")
                    clock.meta = {"status": "ok", "op": op, "rows": n,
                                  "tenant": tenant, "cached": True}
                else:
                    self._span("ok", op, n, time.monotonic() - t0, tenant,
                               cached=True)
                return 200, payload, {}

        self._inflight += 1
        try:
            return await self._routed_dispatch(
                router, model_name, op, body, beta, tenant, deadline,
                timeout_s, cache, cache_key, clock)
        finally:
            self._inflight -= 1

    @staticmethod
    def _request_rows(request) -> int:
        rows = getattr(request, "rows", None)
        return int(rows.shape[0]) if hasattr(rows, "shape") else 0

    @staticmethod
    def _stamp_batcher_phases(clock: _PhaseClock, request) -> None:
        """Fold the batcher worker's stamps into the clock's timeline:
        queue ends at ``collected`` (dequeued into a micro-batch), batch
        at ``dispatch_start`` (engine call began), dispatch at NOW (the
        result reached the loop — includes the loop-wake residual). A
        request the batcher never collected charges its whole wait to
        ``queue``; collected-but-undispatched charges the tail to
        ``batch``. perf_counter is process-wide, so worker-thread stamps
        telescope on the loop's own timeline."""
        now = time.perf_counter()
        collected = getattr(request, "collected", None)
        if collected is None:
            clock.stamp("queue", now)
            return
        clock.stamp("queue", collected)
        dispatch_start = getattr(request, "dispatch_start", None)
        if dispatch_start is None:
            clock.stamp("batch", now)
            return
        clock.stamp("batch", dispatch_start)
        clock.stamp("dispatch", now)

    async def _routed_dispatch(self, router, model_name, op, body, beta,
                               tenant, deadline, timeout_s, cache,
                               cache_key, clock=None) -> tuple[int, dict, dict]:
        # Retry loop: an engine-side failure marks the replica and moves
        # the request to the next healthy one — a client call only fails
        # when EVERY routable replica failed it (or its own input/deadline
        # did). Retries share ONE deadline budget: a client asking for
        # timeout_s must never wait num_replicas x timeout_s.
        tried: set[int] = set()
        last_error: Exception | None = None
        request = None
        owned_any = False   # True once a batcher took the request: its
        #                     span is suppressed, the server's clock owns it
        while len(tried) < len(router.entries):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if clock is not None and owned_any:
                    clock.meta = {"status": "timeout", "op": op,
                                  "rows": self._request_rows(request),
                                  "tenant": tenant}
                return 504, {
                    "error": f"request deadline ({timeout_s}s) exhausted "
                             f"after {len(tried)} failed replica "
                             f"attempt(s); last: {last_error}",
                }, {}
            try:
                entry = router.route(beta=beta, exclude=tried)
            except NoHealthyReplicaError as exc:
                return 503, {
                    "error": (f"{exc} (last replica error: {last_error})"
                              if last_error is not None else str(exc)),
                    "health": router.health(),
                }, {}
            except ValueError as exc:   # β routing without labels
                return 400, {"error": str(exc)}, {}
            try:
                request = entry.batcher.submit(body["x"], op,
                                               timeout_s=remaining,
                                               tenant=tenant,
                                               server_span=clock is not None)
                owned_any = True
                result = await request.wait_async(remaining)
                if clock is not None:
                    self._stamp_batcher_phases(clock, request)
            except QueueFullError as exc:
                # backpressure, not sickness: the replica is busy, the
                # client should back off — never a failure mark
                return 503, {"error": str(exc)}, {}
            except RequestTimeout as exc:
                # a dispatch that missed its deadline marks the replica (a
                # slow replica is a failing replica) — but a deadline that
                # expired while the request was STILL QUEUED is
                # backpressure wearing a timeout's coat (like
                # QueueFullError, deliberately unmarked): under a load
                # spike marking it would eject healthy replicas exactly
                # when capacity matters most. The router additionally
                # refuses to let timeouts eject the LAST serviceable
                # replica. The deadline is spent either way — no retry.
                if not getattr(exc, "in_queue", False):
                    router.report_failure(entry, exc)
                if clock is not None:
                    self._stamp_batcher_phases(clock, request)
                    clock.meta = {"status": "timeout", "op": op,
                                  "rows": self._request_rows(request),
                                  "tenant": tenant}
                return 504, {"error": str(exc)}, {}
            except (ValueError, TypeError) as exc:
                return 400, {"error": str(exc)}, {}
            except BatcherClosed as exc:
                # shutdown in progress, not replica sickness: marking the
                # replica here would emit spurious ejection mitigations
                # (and pollute the faults rollup) for every request caught
                # mid-close
                return 503, {"error": str(exc)}, {}
            except Exception as exc:   # engine fault: mark + retry
                router.report_failure(entry, exc)
                tried.add(entry.index)
                last_error = exc
                if clock is not None:
                    # charge the failed attempt's traversal now; the next
                    # attempt's queue/batch/dispatch ACCUMULATE onto the
                    # same phase names
                    self._stamp_batcher_phases(clock, request)
                continue
            router.report_success(entry)
            if cache is not None and cache_key is not None:
                cache.put(cache_key, result)
            payload = {key: np.asarray(value).tolist()
                       for key, value in result.items()}
            payload["replica"] = entry.describe()
            payload["model"] = model_name
            if clock is not None:
                clock.meta = {"status": "ok", "op": op,
                              "rows": self._request_rows(request),
                              "tenant": tenant}
            return 200, payload, {}
        if clock is not None and owned_any:
            clock.meta = {"status": "error", "op": op,
                          "rows": self._request_rows(request),
                          "tenant": tenant}
        return 503, {
            "error": f"all {len(tried)} replica(s) failed this request; "
                     f"last: {type(last_error).__name__}: {last_error}",
            "health": router.health(),
        }, {}
