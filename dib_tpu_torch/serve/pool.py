"""Multi-process replica pool: engines in worker subprocesses
(counterpart of ``dib_tpu/serve/pool.py``).

The thread-based replica story (``serve/replicas.py``) runs every replica's
Python work (request unpickling, padding, result splitting, the forward
pass's launches) under ONE GIL. This module moves each replica's engine into
a worker SUBPROCESS behind a pipe request plane:

  - :func:`_worker_main` runs in the child: it builds the model and engine
    from a pickled spec (the model's constructor arguments and a numpy
    state dict; no checkpoint machinery and no device tensor crosses the
    process boundary) and answers ``{"op", "rows"}`` messages until told to
    stop.
  - :class:`WorkerReplica` is the parent-side client, shaped like an
    ``InferenceEngine`` (``predict``/``encode``/``feature_width``/
    ``bucket_for``/``max_bucket``), so a ``MicroBatcher`` and
    ``ReplicaEntry`` sit in front of it unchanged: continuous batching
    happens in the parent, the padded batch crosses the pipe once, and the
    forward pass runs under the CHILD's GIL.
  - :func:`pool_router` assembles a ``ReplicaRouter`` over N workers; the
    health machinery applies verbatim: a DEAD worker surfaces as
    :class:`WorkerDiedError` on dispatch, the server's retry loop moves the
    request to a surviving replica, and the router's probe respawns the
    worker (:meth:`WorkerReplica.probe`).

Processes are ``spawn``-context: a process that has initialised CUDA cannot
be forked. Each worker pays a fresh interpreter and ``import torch``;
``pool_router`` starts the workers together and waits for all of them.

Unlike the JAX package's workers, which pin themselves to the CPU
(``JAX_PLATFORMS=cpu``), a port worker runs its engine on the device its
spec names: from the CLI that is the card, since the port's entry points
run on the card. A worker that cannot build its engine there (no CUDA
device, a bad spec) fails with :class:`WorkerDiedError`; it never carries on
somewhere else.
"""

from __future__ import annotations

import multiprocessing
import os
import threading
import time

import numpy as np

__all__ = ["WorkerDiedError", "WorkerReplica", "pool_router", "worker_spec"]

_STARTUP_TIMEOUT_S = 300.0
_POLL_S = 0.05


class WorkerDiedError(RuntimeError):
    """The worker subprocess exited (or its pipe broke) mid-dispatch —
    the replica-level failure the router's ejection/retry machinery
    consumes."""


def worker_spec(model, batch_buckets=(1, 8, 32, 128), beta_end: float | None = None,
                device=None) -> dict:
    """The picklable recipe a worker builds its engine from: the
    ``DistributedIBModel``'s constructor arguments (``model.architecture``)
    and its weights as a HOST numpy state dict, the buckets, the β label and
    the device (``None`` means the GPU) — device tensors never cross a
    process boundary."""
    return {
        "architecture": dict(model.architecture),
        "state_dict": {name: value.detach().cpu().numpy()
                       for name, value in model.state_dict().items()},
        "buckets": tuple(int(b) for b in batch_buckets),
        "beta_end": beta_end,
        "device": None if device is None else str(device),
    }


def _worker_main(conn, spec: dict) -> None:   # pragma: no cover - subprocess
    """Child entry point: build the engine on the spec's device, serve the
    pipe until EOF/stop."""
    try:
        from dib_tpu_torch.serve.engine import InferenceEngine

        engine = InferenceEngine.from_state(
            spec["architecture"], spec["state_dict"], batch_buckets=spec["buckets"],
            device=spec["device"], beta_end=spec.get("beta_end"),
        )
        conn.send({"ready": True,
                   "pid": os.getpid(),
                   "device": str(engine.device),
                   "feature_width": engine.feature_width,
                   "num_features": engine.num_features,
                   "buckets": list(engine.buckets)})
    except Exception as exc:
        try:
            conn.send({"ready": False,
                       "error": f"{type(exc).__name__}: {exc}"})
        finally:
            conn.close()
        return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if not isinstance(msg, dict) or msg.get("op") == "__stop__":
            break
        try:
            out = getattr(engine, msg["op"])(msg["rows"])
            conn.send({"ok": True, "result": out})
        except Exception as exc:
            conn.send({"ok": False,
                       "error": f"{type(exc).__name__}: {exc}"})
    conn.close()


class WorkerReplica:
    """Engine-shaped client over one worker subprocess.

    The router's re-admission probe heals a dead worker: a probe dispatch
    against a dead process relaunches it (fresh interpreter, same spec)
    instead of failing forever — process death degrades the pool, the
    probe grows it back.
    """

    def __init__(self, spec: dict):
        self.spec = spec
        dims = spec["architecture"]["feature_dimensionalities"]
        self.feature_width = int(sum(dims))
        self.num_features = len(dims)
        self.buckets = tuple(spec["buckets"])
        self.beta_end = spec.get("beta_end")
        self.pid: int | None = None
        self.device: str | None = None     # the engine's device, from the hello
        self.respawns = 0
        self._ctx = multiprocessing.get_context("spawn")
        self._lock = threading.Lock()   # one in-flight dispatch per worker
        self._closed = False
        self._proc = None
        self._conn = None
        self._spawn_locked()

    # ------------------------------------------------------------ lifecycle
    def _spawn_locked(self) -> None:
        """(Re)launch the subprocess; caller holds no dispatch in flight.
        Does NOT wait for readiness — ``wait_ready`` (or the first
        dispatch) does, so a pool's workers warm up concurrently."""
        parent, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_worker_main, args=(child, self.spec),
            name="dib-serve-pool-worker", daemon=True,
        )
        self._proc.start()
        child.close()
        self._conn = parent
        self._ready = False

    def wait_ready(self) -> None:
        """Block until the worker's hello (engine built); raises
        ``WorkerDiedError`` on startup failure."""
        with self._lock:
            self._wait_ready_locked()

    def _wait_ready_locked(self) -> None:
        if self._ready:
            return
        deadline = time.monotonic() + _STARTUP_TIMEOUT_S
        while not self._conn.poll(_POLL_S):
            if not self._proc.is_alive():
                raise WorkerDiedError(
                    f"pool worker died during startup "
                    f"(exitcode {self._proc.exitcode})")
            if time.monotonic() > deadline:
                raise WorkerDiedError(
                    f"pool worker not ready within {_STARTUP_TIMEOUT_S}s")
        try:
            hello = self._conn.recv()
        except (EOFError, OSError) as exc:
            raise WorkerDiedError(f"pool worker hello failed: {exc}") from exc
        if not hello.get("ready"):
            raise WorkerDiedError(
                f"pool worker failed to build its engine: "
                f"{hello.get('error', 'unknown error')}")
        if hello["feature_width"] != self.feature_width:
            raise WorkerDiedError(
                f"pool worker serves width {hello['feature_width']}, "
                f"expected {self.feature_width}")
        self.pid = hello.get("pid")
        self.device = hello.get("device")
        self._ready = True

    def alive(self) -> bool:
        return (not self._closed and self._proc is not None
                and self._proc.is_alive())

    def _ensure_alive_locked(self, allow_respawn: bool) -> None:
        if self._proc.is_alive():
            return
        if self._closed or not allow_respawn:
            raise WorkerDiedError(
                f"pool worker (pid {self.pid}) is dead "
                f"(exitcode {self._proc.exitcode})")
        # Heal path: reached ONLY from the router's re-admission probe
        # (via :meth:`probe`) — a regular dispatch against a dead worker
        # must fail over to a surviving replica immediately, not park the
        # client behind a multi-second respawn. The dead process's exit
        # already failed any in-flight request (the lock holder saw the
        # broken pipe), so respawning here is race-free.
        try:
            self._conn.close()
        except OSError:
            pass
        self._spawn_locked()
        self.respawns += 1

    # ------------------------------------------------------------- dispatch
    def _call(self, op: str, x, allow_respawn: bool = False) -> dict:
        rows = np.asarray(x, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        with self._lock:
            if self._closed:
                raise WorkerDiedError("pool worker is closed")
            self._ensure_alive_locked(allow_respawn)
            self._wait_ready_locked()
            try:
                self._conn.send({"op": op, "rows": rows})
                while not self._conn.poll(_POLL_S):
                    if not self._proc.is_alive():
                        raise WorkerDiedError(
                            f"pool worker (pid {self.pid}) died mid-dispatch "
                            f"(exitcode {self._proc.exitcode})")
                reply = self._conn.recv()
            except (EOFError, OSError, BrokenPipeError) as exc:
                raise WorkerDiedError(
                    f"pool worker (pid {self.pid}) pipe broke: {exc}"
                ) from exc
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "pool worker error"))
        return reply["result"]

    def predict(self, x) -> dict:
        return self._call("predict", x)

    def encode(self, x) -> dict:
        return self._call("encode", x)

    def probe(self, x) -> dict:
        """The router's re-admission probe dispatch: unlike
        ``predict``, a DEAD worker is respawned first (fresh interpreter,
        same spec) — process death degrades the pool, the probe grows it
        back."""
        return self._call("predict", x, allow_respawn=True)

    # ---------------------------------------------------- engine interface
    def bucket_for(self, n: int) -> int:
        for bucket in self.buckets:
            if bucket >= n:
                return bucket
        return self.buckets[-1]

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    # -------------------------------------------------------------- drills
    def kill(self) -> None:
        """SIGKILL the worker (fault drills / tests) — the next dispatch
        surfaces ``WorkerDiedError``."""
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=10.0)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                if self._proc is not None and self._proc.is_alive():
                    self._conn.send({"op": "__stop__"})
            except (OSError, BrokenPipeError):
                pass
            try:
                self._conn.close()
            except OSError:
                pass
        if self._proc is not None:
            self._proc.join(timeout=10.0)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=5.0)


def pool_router(model, num_workers: int,
                batch_buckets=(1, 8, 32, 128),
                beta_end: float | None = None,
                telemetry=None, registry=None, tracer=None,
                eject_after: int = 3, probe_after_s: float = 5.0,
                probe_timeout_s: float = 5.0,
                device=None,
                **batcher_kwargs):
    """A ``ReplicaRouter`` over ``num_workers`` subprocess replicas of
    ``model``, each worker's engine on ``device`` (``None`` means the GPU).

    Workers spawn concurrently and the router returns once all are ready;
    a worker that cannot build its engine fails construction with
    ``WorkerDiedError``. The standard health machinery rides on top:
    ejection after ``eject_after`` consecutive failures, per-request retry
    on surviving replicas in the server, probe-driven respawn and
    re-admission. The PARENT writes the events: ``tracer`` receives the
    batchers' spans and ``telemetry`` the router's ``mitigation`` events; a
    worker subprocess writes none.
    """
    from dib_tpu_torch.serve.batcher import MicroBatcher
    from dib_tpu_torch.serve.replicas import ReplicaEntry, ReplicaRouter

    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    spec = worker_spec(model, batch_buckets=batch_buckets, beta_end=beta_end, device=device)
    workers = [WorkerReplica(spec) for _ in range(num_workers)]
    try:
        for worker in workers:
            worker.wait_ready()
    except WorkerDiedError:
        for worker in workers:
            worker.close()
        raise
    entries = []
    for i, worker in enumerate(workers):
        batcher = MicroBatcher(worker, tracer=tracer, registry=registry,
                               **batcher_kwargs)
        entries.append(ReplicaEntry(worker, batcher, i, beta_end=beta_end,
                                    device=worker.device))
    return ReplicaRouter(entries, eject_after=eject_after,
                         probe_after_s=probe_after_s,
                         probe_timeout_s=probe_timeout_s,
                         telemetry=telemetry, registry=registry)
