"""Replica fan-out for serving: devices and β-sweep members
(counterpart of ``dib_tpu/serve/replicas.py``).

Two independent axes of replication meet here:

  - **Device replicas**: the same weights on several CUDA devices, each
    with its own engine and micro-batcher, dispatched round-robin.
  - **β replicas**: a ``BetaSweepTrainer`` checkpoint holds R models, one
    per annealing endpoint. Serving them side by side lets a client query
    "the model at β≈x": the entry whose endpoint is nearest in log-β.

The router owns the batchers (one per entry: batching never crosses
replicas, which would entangle their latency) and is the single object the
HTTP server talks to.

Health: the router tracks per-replica consecutive dispatch failures.
``eject_after`` failures in a row eject the replica (routing skips it, so
one sick device stops failing client calls), and a background probe
re-dispatches a tiny request against the ejected engine every
``probe_after_s``; the first success re-admits it, and the same loop revives
a batcher whose worker thread died. Transitions count in the registry
(``serve.replicas.ejected``/``readmitted``, ``serve.batchers.restarted``)
and land as ``mitigation`` events (``replica_ejected``,
``replica_readmitted``, ``batcher_restarted``) on the serving run's event
stream. ``/healthz`` reports the full per-replica picture
(``router.health()``).
"""

from __future__ import annotations

import copy
import math
import threading
import time
from typing import Sequence

import numpy as np
import torch

from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.serve.batcher import MicroBatcher, RequestTimeout
from dib_tpu_torch.serve.engine import DEFAULT_BUCKETS, InferenceEngine

__all__ = ["NoHealthyReplicaError", "ReplicaEntry", "ReplicaRouter", "local_devices"]


def local_devices(device=None) -> list[torch.device]:
    """The devices a router replicates over: every CUDA device
    (``cuda:0`` .. ``cuda:{n-1}``, the counterpart of ``jax.local_devices()``)
    when ``device`` is ``None``, else ``[device]``. Raises without a CUDA
    device rather than fall back to the CPU."""
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


class NoHealthyReplicaError(RuntimeError):
    """Every routable replica is ejected (or excluded) — the request cannot
    be served until a probe re-admits one."""


class ReplicaEntry:
    """One servable replica: an engine, its batcher, its labels, and its
    health state (owned by the router's lock)."""

    def __init__(self, engine, batcher: MicroBatcher,
                 index: int, beta_end: float | None = None, device=None):
        self.engine = engine
        self.batcher = batcher
        self.index = index
        self.beta_end = beta_end
        self.device = device
        # health state — mutated only under ReplicaRouter._health_lock
        self.consecutive_failures = 0
        self.ejected = False
        self.ejected_at: float | None = None   # monotonic
        self.last_error: str | None = None
        self.probe_inflight = False            # a probe thread is out on it

    def describe(self) -> dict:
        entry = {"replica": self.index}
        if self.beta_end is not None:
            entry["beta_end"] = float(self.beta_end)
        if self.device is not None:
            entry["device"] = str(self.device)
        return entry

    def health(self) -> dict:
        """The ``/healthz`` row for this replica."""
        row = self.describe()
        row.update({
            "ejected": self.ejected,
            "consecutive_failures": self.consecutive_failures,
            "batcher_alive": self.batcher.is_alive(),
        })
        if self.last_error:
            row["last_error"] = self.last_error
        return row

    def serviceable(self) -> bool:
        return not self.ejected and self.batcher.is_alive()


class ReplicaRouter:
    """Round-robin (and β-nearest) dispatch over HEALTHY replica entries.

    ``eject_after``: consecutive dispatch failures before a replica stops
    receiving traffic. ``probe_after_s``: how long an ejected replica
    rests before the background probe thread re-tries it (0 disables the
    thread; ``probe_ejected()`` can still be called directly, e.g. by
    tests and drills). ``probe_timeout_s``: a probe dispatch slower than
    this counts as a FAILED probe — a replica ejected for timing out
    would otherwise pass an unbounded probe while still unable to meet
    any request deadline, flapping eject/re-admit forever.
    """

    def __init__(self, entries: Sequence[ReplicaEntry],
                 eject_after: int = 3, probe_after_s: float = 5.0,
                 probe_timeout_s: float = 5.0,
                 telemetry=None, registry=None):
        if not entries:
            raise ValueError("router needs at least one replica entry")
        if eject_after < 1:
            raise ValueError(f"eject_after must be >= 1, got {eject_after}")
        self.entries = list(entries)
        self.eject_after = int(eject_after)
        self.probe_after_s = float(probe_after_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.telemetry = telemetry
        self.registry = registry
        self._rr = 0
        self._lock = threading.Lock()          # round-robin cursor
        self._health_lock = threading.Lock()   # entry health state
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        # the maintenance thread runs from the start (idle ticks are one
        # Event.wait each): it must notice a dead batcher worker even when
        # no replica was ever ejected
        self._ensure_probe_thread()

    # ------------------------------------------------------------- routing
    def route(self, beta: float | None = None,
              exclude: Sequence[int] = ()) -> ReplicaEntry:
        """Pick a healthy replica: round-robin by default; with ``beta``,
        the entry whose annealing endpoint is nearest in log-β (the grids
        are log-spaced, so log distance is the natural metric; non-positive
        operands fall back to linear distance). ``exclude`` skips replica
        indices this request already failed on (the server's retry loop).
        """
        if beta is not None:
            labeled = [e for e in self.entries if e.beta_end is not None]
            if not labeled:
                raise ValueError(
                    "beta-targeted routing needs β-labeled replicas "
                    "(serve a sweep checkpoint)"
                )
            candidates = [e for e in labeled
                          if e.serviceable() and e.index not in exclude]
            if not candidates:
                raise NoHealthyReplicaError(
                    "no healthy β-labeled replica available "
                    f"({len(labeled)} labeled, all ejected/dead or "
                    "excluded)"
                )

            def distance(entry: ReplicaEntry) -> float:
                b = float(entry.beta_end)
                if beta > 0 and b > 0:
                    return abs(math.log(b) - math.log(beta))
                return abs(b - beta)

            return min(candidates, key=distance)
        # serviceable() also excludes entries whose batcher worker died: a
        # request routed there would sit in a queue nothing drains until
        # its deadline — /healthz already reports that entry unserviceable
        # and routing must agree with it
        candidates = [e for e in self.entries
                      if e.serviceable() and e.index not in exclude]
        if not candidates:
            raise NoHealthyReplicaError(
                f"no healthy replica available ({len(self.entries)} "
                "configured, all ejected/dead or excluded)"
            )
        with self._lock:
            entry = candidates[self._rr % len(candidates)]
            self._rr += 1
        return entry

    # -------------------------------------------------------------- health
    def report_failure(self, entry: ReplicaEntry, error=None) -> None:
        """One dispatch failure on ``entry``; ejects at ``eject_after``
        consecutive failures (and starts the re-admission probe).

        Timeout-class failures can be SYSTEMIC (a load spike makes every
        replica miss deadlines, not just a sick one), so they are never
        allowed to eject the last serviceable replica — overload must
        degrade to 504s, not convert into a hard 503 outage that only a
        probe can lift."""
        with self._health_lock:
            entry.consecutive_failures += 1
            entry.last_error = (f"{type(error).__name__}: {error}"
                                if error is not None else None)
            should_eject = (not entry.ejected
                            and entry.consecutive_failures >= self.eject_after)
            if should_eject and isinstance(error, RequestTimeout):
                others = any(e is not entry and e.serviceable()
                             for e in self.entries)
                if not others:
                    should_eject = False
            if should_eject:
                entry.ejected = True
                entry.ejected_at = time.monotonic()
        if should_eject:
            if self.registry is not None:
                self.registry.counter("serve.replicas.ejected").inc()
            if self.telemetry is not None:
                self.telemetry.mitigation(
                    mtype="replica_ejected", replica=entry.index,
                    consecutive_failures=entry.consecutive_failures,
                    error=entry.last_error,
                )
            self._ensure_probe_thread()

    def report_success(self, entry: ReplicaEntry) -> None:
        """One successful dispatch; re-admits the entry if it was ejected."""
        with self._health_lock:
            entry.consecutive_failures = 0
            readmitted = entry.ejected
            if readmitted:
                entry.ejected = False
                entry.ejected_at = None
                entry.last_error = None
        if readmitted:
            if self.registry is not None:
                self.registry.counter("serve.replicas.readmitted").inc()
            if self.telemetry is not None:
                self.telemetry.mitigation(mtype="replica_readmitted", replica=entry.index)

    def probe_ejected(self, force: bool = False) -> int:
        """One health-maintenance tick: revive dead batcher workers, then
        probe every ejected entry whose rest period elapsed with one tiny
        direct engine dispatch — a success re-admits it, a failure re-arms
        its rest timer. Returns the number of entries re-admitted. Called
        by the background maintenance thread; also directly by
        tests/drills — ``force=True`` ignores the rest period for
        deterministic re-admission."""
        readmitted = 0
        now = time.monotonic()
        for entry in self.entries:
            if entry.batcher.revive():
                if self.registry is not None:
                    self.registry.counter("serve.batchers.restarted").inc()
                if self.telemetry is not None:
                    self.telemetry.mitigation(mtype="batcher_restarted", replica=entry.index)
        for entry in self.entries:
            with self._health_lock:
                due = entry.ejected and not entry.probe_inflight and (
                    force or (entry.ejected_at is not None
                              and now - entry.ejected_at >= self.probe_after_s)
                )
                if due:
                    entry.probe_inflight = True
            if not due:
                continue
            # The probe dispatch runs on a disposable thread joined with a
            # bound: a HUNG device (the canonical sick-replica case) must
            # not wedge the one maintenance thread forever — that would
            # silently disable probing and batcher revival for the whole
            # process. probe_inflight keeps hung probes from piling up.
            outcome: dict = {}

            def _probe(entry=entry, outcome=outcome):
                t0 = time.monotonic()
                try:
                    # an engine with a dedicated probe op gets it (pool
                    # workers respawn their dead subprocess there —
                    # something a live-traffic dispatch must never do)
                    probe_fn = getattr(entry.engine, "probe",
                                       entry.engine.predict)
                    probe_fn(np.zeros(
                        (1, entry.engine.feature_width), np.float32))
                except Exception as exc:
                    outcome["error"] = f"{type(exc).__name__}: {exc}"
                else:
                    outcome["elapsed"] = time.monotonic() - t0
                finally:
                    with self._health_lock:
                        entry.probe_inflight = False

            prober = threading.Thread(target=_probe, daemon=True,
                                      name="dib-serve-probe-dispatch")
            prober.start()
            prober.join(self.probe_timeout_s)
            with self._health_lock:
                if prober.is_alive():
                    # hung: count as failed; the daemon thread clears
                    # probe_inflight if the dispatch ever returns, and the
                    # NEXT probe decides re-admission
                    entry.ejected_at = time.monotonic()
                    entry.last_error = (
                        f"probe: dispatch hung beyond "
                        f"probe_timeout_s={self.probe_timeout_s}")
                    continue
                if "error" in outcome:
                    entry.ejected_at = time.monotonic()
                    entry.last_error = f"probe: {outcome['error']}"
                    continue
                if outcome.get("elapsed", 0.0) > self.probe_timeout_s:
                    # "succeeded" but slower than any request deadline
                    # could tolerate: re-admitting would flap
                    # eject/re-admit with client-visible 504s in between
                    entry.ejected_at = time.monotonic()
                    entry.last_error = (
                        f"probe: dispatch took {outcome['elapsed']:.2f}s "
                        f"(> probe_timeout_s={self.probe_timeout_s})")
                    continue
            self.report_success(entry)
            readmitted += 1
        return readmitted

    def _ensure_probe_thread(self) -> None:
        if self.probe_after_s <= 0 or self._probe_stop.is_set():
            return
        with self._lock:
            if self._probe_thread is not None and self._probe_thread.is_alive():
                return
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="dib-serve-probe", daemon=True,
            )
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        interval = max(min(self.probe_after_s / 4.0, 1.0), 0.05)
        while not self._probe_stop.wait(interval):
            self.probe_ejected()

    def health(self) -> dict:
        """The router-level health picture ``/healthz`` serves."""
        rows = [entry.health() for entry in self.entries]
        return {
            "replicas": rows,
            "healthy": sum(1 for r in rows
                           if not r["ejected"] and r["batcher_alive"]),
            "ejected": sum(1 for r in rows if r["ejected"]),
            "batchers_dead": sum(1 for r in rows if not r["batcher_alive"]),
        }

    def serviceable(self) -> bool:
        """True iff at least one replica can actually carry a request."""
        return any(entry.serviceable() for entry in self.entries)

    def describe(self) -> list[dict]:
        return [entry.describe() for entry in self.entries]

    def close(self) -> None:
        self._probe_stop.set()
        thread = self._probe_thread
        if thread is not None:
            thread.join(timeout=5.0)
        for entry in self.entries:
            entry.batcher.close()

    # -------------------------------------------------------- construction
    @classmethod
    def from_params(
        cls,
        model,
        params: dict | None = None,
        devices=None,
        batch_buckets: Sequence[int] = DEFAULT_BUCKETS,
        telemetry=None,
        registry=None,
        tracer=None,
        eject_after: int = 3,
        probe_after_s: float = 5.0,
        probe_timeout_s: float = 5.0,
        **batcher_kwargs,
    ) -> "ReplicaRouter":
        """One engine+batcher per device (default: every CUDA device, see
        :func:`local_devices`), each over its own copy of ``model`` loaded
        with ``params`` (a state dict; ``None`` keeps the model's weights).
        ``telemetry`` receives the router's ``mitigation`` events and
        ``tracer`` the batchers' spans; the engines write no ``compile``
        event, since they compile nothing."""
        devices = list(devices) if devices is not None else local_devices()
        entries = []
        for i, device in enumerate(devices):
            replica = copy.deepcopy(model)
            if params is not None:
                replica.load_state_dict({name: torch.as_tensor(value)
                                         for name, value in params.items()})
            engine = InferenceEngine(replica, batch_buckets=batch_buckets,
                                     device=device, registry=registry)
            batcher = MicroBatcher(engine, tracer=tracer, registry=registry,
                                   **batcher_kwargs)
            entries.append(ReplicaEntry(engine, batcher, i, device=engine.device))
        return cls(entries, eject_after=eject_after,
                   probe_after_s=probe_after_s,
                   probe_timeout_s=probe_timeout_s,
                   telemetry=telemetry, registry=registry)

    @classmethod
    def from_sweep(
        cls,
        sweep,
        states,
        batch_buckets: Sequence[int] = DEFAULT_BUCKETS,
        telemetry=None,
        registry=None,
        tracer=None,
        eject_after: int = 3,
        probe_after_s: float = 5.0,
        probe_timeout_s: float = 5.0,
        **batcher_kwargs,
    ) -> "ReplicaRouter":
        """One β-labeled engine per sweep member, each over member r carved
        out of the sweep's stacked model (``model.carve(r)``) on the sweep's
        device. The labels are the sweep's float64 host endpoints
        (``beta_ends_host``)."""
        stacked = states.params["model"]
        beta_ends = [float(b) for b in sweep.beta_ends_host]
        entries = []
        for r in range(sweep.num_replicas):
            engine = InferenceEngine(
                stacked.carve(r), batch_buckets=batch_buckets, device=sweep.device,
                registry=registry, beta_end=beta_ends[r],
            )
            batcher = MicroBatcher(engine, tracer=tracer, registry=registry,
                                   **batcher_kwargs)
            entries.append(
                ReplicaEntry(engine, batcher, r, beta_end=beta_ends[r])
            )
        return cls(entries, eject_after=eject_after,
                   probe_after_s=probe_after_s,
                   probe_timeout_s=probe_timeout_s,
                   telemetry=telemetry, registry=registry)
