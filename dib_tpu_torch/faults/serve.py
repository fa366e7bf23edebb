"""Serve-scope fault injectors: sick replicas and dead batcher threads
(counterpart of ``dib_tpu/faults/serve.py``).

:class:`FlakyEngine` wraps an :class:`~dib_tpu_torch.serve.engine.InferenceEngine`
and makes its dispatches fail or crawl on schedule — the deterministic
stand-in for a sick device behind one serving replica. The router's health
tracking (``serve/replicas.py``) must eject it after consecutive failures,
keep client calls flowing through the healthy replicas, and re-admit it
via probe once it heals. With ``telemetry=`` every injection lands as a
``fault`` event (``replica_error`` or ``replica_slow``, tagged with the
``replica`` index), on the same stream as the ``mitigation`` events it
provokes.

``kill_batcher_worker`` crashes a micro-batcher's dispatch thread the way
a real bug would (an exception escaping the drain loop) — the fault the
truthful ``/healthz`` 503 exists to surface.
"""

from __future__ import annotations

import threading
import time

__all__ = ["FlakyEngine", "InjectedReplicaFault", "kill_batcher_worker"]


class InjectedReplicaFault(RuntimeError):
    """Raised by a :class:`FlakyEngine` dispatch while its fault is armed."""


class FlakyEngine:
    """A proxy engine whose next ``fail_next`` dispatches raise and/or
    whose every dispatch sleeps ``delay_s`` first.

    Thread-safe: serving dispatches from batcher worker + router probe
    threads decrement the one fault budget under a lock. ``heal()`` clears
    both faults at once. Non-dispatch attributes (``feature_width``,
    ``bucket_for``, ...) pass through to the wrapped engine, so the proxy
    drops into any ``ReplicaEntry`` unchanged.
    """

    def __init__(self, engine, fail_next: int = 0, delay_s: float = 0.0,
                 telemetry=None, replica: int | None = None):
        self._engine = engine
        self._telemetry = telemetry
        self._replica = replica
        self._lock = threading.Lock()
        self.fail_next = int(fail_next)
        self.delay_s = float(delay_s)
        self.injected = 0          # total faults actually fired

    def heal(self) -> None:
        with self._lock:
            self.fail_next = 0
            self.delay_s = 0.0

    def _maybe_fault(self, op: str) -> None:
        with self._lock:
            delay = self.delay_s
            fail = self.fail_next > 0
            if fail:
                self.fail_next -= 1
            if fail or delay > 0:
                self.injected += 1
                if self._telemetry is not None:
                    self._telemetry.fault(
                        kind="replica_error" if fail else "replica_slow",
                        op=op, replica=self._replica,
                        **({"delay_s": delay} if delay > 0 else {}),
                    )
        if delay > 0:
            time.sleep(delay)
        if fail:
            raise InjectedReplicaFault(
                f"injected replica fault on {op!r} (drill)"
            )

    def predict(self, x) -> dict:
        self._maybe_fault("predict")
        return self._engine.predict(x)

    def encode(self, x) -> dict:
        self._maybe_fault("encode")
        return self._engine.encode(x)

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self._engine, attr)


class _WorkerBomb:
    """A queue entry whose ``rows`` access raises — the exception escapes
    the batcher's collect loop and kills the worker thread, exactly like a
    dispatch-path bug would."""

    op = "predict"
    deadline = None
    submitted = 0.0

    @property
    def rows(self):
        raise RuntimeError("injected batcher-worker crash (fault drill)")

    def set_error(self, error) -> None:   # the bomb has no caller waiting
        pass


def kill_batcher_worker(batcher, telemetry=None, timeout_s: float = 10.0) -> bool:
    """Deterministically crash ``batcher``'s dispatch thread.

    Returns True when the thread died within ``timeout_s``. Emits a
    ``fault`` event (kind ``batcher_crash``) so the drill is auditable.
    """
    if telemetry is not None:
        telemetry.fault(kind="batcher_crash")
    batcher._queue.put(_WorkerBomb())
    batcher._worker.join(timeout_s)
    return not batcher._worker.is_alive()
