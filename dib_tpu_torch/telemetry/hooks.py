"""The fit's instrumentation: chunk events, spans, heartbeats and a
``PhaseTimer`` (counterpart of ``dib_tpu/telemetry/hooks.py``).

:class:`FitRecorder` is what ``DIBTrainer.fit`` and ``BetaSweepTrainer.fit``
record through: a ``chunk`` span around each chunk (it waits for the
chunk's work, so the interval is wall-clock of the device's work too), one
``chunk`` event per boundary with the boundary row and memory, step
counters and the chunk-seconds histogram, a ``boundary`` heartbeat with the
trailing inter-boundary intervals (the watchdog's stall clock), mid-chunk
heartbeats from a daemon thread every ``DIB_HEARTBEAT_S`` seconds, and a
``metrics`` event at the end. With ``telemetry=None`` it does nothing and
never waits on the device.

The heartbeat thread only writes events: it never synchronizes the device
and never launches a kernel.

A departure from the JAX package: ``record_compile`` and its utilization
gauges read XLA's cost analysis of the compiled chunk program (FLOPs and
bytes); eager PyTorch compiles no chunk program, so the port writes no
``compile`` event and keeps no achieved-FLOP/s gauge.

:class:`ChunkPhaseHooks` splits each boundary's wall-clock into the chunk
and the instrumentation between its ``pre`` and ``post`` hooks.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from dib_tpu_torch.telemetry.events import device_memory_stats, host_memory_stats
from dib_tpu_torch.telemetry.trace import Tracer
from dib_tpu_torch.utils.profiling import PhaseTimer, block_until_ready

__all__ = ["ChunkPhaseHooks", "FitRecorder", "heartbeat_interval_s"]

# trailing inter-boundary intervals a boundary beat carries (HeartbeatHook.keep)
_KEEP_INTERVALS = 32


def heartbeat_interval_s() -> float:
    """The mid-chunk heartbeat interval: ``DIB_HEARTBEAT_S`` seconds
    (default 10; 0 turns the heartbeat thread off, boundary beats stay)."""
    try:
        return float(os.environ.get("DIB_HEARTBEAT_S", "10"))
    except ValueError:
        return 10.0


class _NullPhase:
    """Span handle when telemetry is off: never waits."""

    def block_on(self, *outputs) -> None:
        pass

    def annotate(self, **fields) -> None:
        pass


class FitRecorder:
    """Per-chunk instrumentation of a fit (see the module docstring).

    ``steps_per_epoch`` counts every replica's steps for a sweep
    (``steps_per_epoch * R``).
    """

    def __init__(self, telemetry, *, steps_per_epoch: int):
        self.telemetry = telemetry
        self.steps_per_epoch = int(steps_per_epoch)
        self.timer = self.registry = self.tracer = None
        self._hb_lock = threading.Lock()
        self._beats = 0
        self._boundary_intervals: list[float] = []
        # anchored at fit start: the first interval includes the set-up, as
        # HeartbeatHook's does (the watchdog's steady median starts at [1])
        self._last_boundary_t: float | None = time.perf_counter()
        self._last_epoch = 0
        self._chunk_t0: float | None = None
        if telemetry is not None:
            from dib_tpu_torch.telemetry.metrics import MetricsRegistry

            self.timer = PhaseTimer()
            self.registry = MetricsRegistry()
            self.tracer = Tracer(telemetry, timer=self.timer)

    @contextlib.contextmanager
    def chunk_phase(self, **tags):
        """Wrap one ``run_chunk``; ``.block_on(outputs)`` inside."""
        if self.tracer is None:
            yield _NullPhase()
            return
        self._chunk_t0 = time.perf_counter()      # read by the heartbeat thread
        try:
            with self.tracer.span("chunk", **tags) as handle:
                yield handle
        finally:
            self._chunk_t0 = None

    def _emit_heartbeat(self, phase: str, **fields) -> None:
        if self.telemetry is None:
            return
        with self._hb_lock:
            self._beats += 1
            beat = self._beats
        self.telemetry.heartbeat(beat=beat, epoch=self._last_epoch, phase=phase, **fields)

    @contextlib.contextmanager
    def heartbeats(self, interval_s: float | None = None):
        """Run the fit under a daemon thread that beats every
        ``interval_s`` (default ``DIB_HEARTBEAT_S``): phase ``chunk`` with
        the chunk's elapsed seconds while one is in flight, ``host``
        between chunks. No-op when telemetry is off or the interval is 0."""
        interval = heartbeat_interval_s() if interval_s is None else float(interval_s)
        if self.telemetry is None or interval <= 0:
            yield
            return
        stop = threading.Event()

        def beat_loop():
            while not stop.wait(interval):
                t0 = self._chunk_t0
                fields = {"interval_s": interval}
                if t0 is not None:
                    fields["phase_elapsed_s"] = round(time.perf_counter() - t0, 3)
                self._emit_heartbeat("chunk" if t0 is not None else "host", **fields)

        thread = threading.Thread(target=beat_loop, name="dib-heartbeat", daemon=True)
        thread.start()
        try:
            yield
        finally:
            stop.set()
            thread.join(timeout=max(1.0, interval))

    def record_chunk(self, *, epoch: int, chunk_epochs: int, **fields) -> None:
        """One ``chunk`` event from the chunk just timed, the metric
        updates and a boundary heartbeat; ``fields`` carry the fetched
        boundary row (numbers for a serial fit, [R] lists for a sweep)."""
        if self.telemetry is None:
            return
        seconds = self.timer.intervals["chunk"][-1]
        steps = chunk_epochs * self.steps_per_epoch
        self.telemetry.chunk(epoch=epoch, steps=steps, seconds=seconds, epochs=chunk_epochs,
                             memory=device_memory_stats(), host_memory=host_memory_stats(),
                             **fields)
        self.registry.counter("steps").inc(steps)
        self.registry.histogram("chunk_s").record(seconds)
        self.registry.gauge("epoch").set(epoch)
        self._last_epoch = int(epoch)
        now = time.perf_counter()
        if self._last_boundary_t is not None:
            self._boundary_intervals.append(round(now - self._last_boundary_t, 2))
            del self._boundary_intervals[:-_KEEP_INTERVALS]
        self._last_boundary_t = now
        self._emit_heartbeat("boundary", intervals_s=list(self._boundary_intervals))

    def finish(self) -> None:
        """The end-of-fit ``metrics`` event."""
        if self.telemetry is None:
            return
        from dib_tpu_torch.telemetry.metrics import write_metrics

        write_metrics(self.registry, self.telemetry)


class ChunkPhaseHooks:
    """A pre/post hook pair that splits each boundary's wall-clock::

        phases = ChunkPhaseHooks(telemetry=writer, steps_per_epoch=50)
        hooks = [phases.pre, *instrumentation_hooks, phases.post]
        phases.start()
        trainer.fit(generator, hooks=hooks, hook_every=chunk_epochs)
        phases.timer.intervals["chunk"]            # train seconds per chunk
        phases.timer.intervals["instrumentation"]  # hook seconds per chunk

    ``pre`` waits for the chunk's work (a CUDA event on the current stream)
    before closing the chunk interval. With a ``tracer`` each interval is
    also a ``span`` event, the hooks between ``pre`` and ``post``
    parenting under "instrumentation". ``baseline_known=False``: the first
    interval's step count is unknown (a resumed run), so it is timed but
    not written as a chunk event.
    """

    def __init__(self, timer: PhaseTimer | None = None, telemetry=None,
                 steps_per_epoch: int = 0, baseline_known: bool = True,
                 tracer: Tracer | None = None):
        if tracer is not None and timer is None:
            timer = tracer.timer
        self.timer = timer or PhaseTimer()
        self.telemetry = telemetry
        self.tracer = tracer
        self.steps_per_epoch = steps_per_epoch
        self._t = time.perf_counter()
        self._open = None
        self._last_epoch = 0
        self._baseline_known = baseline_known

    def _add(self, name: str, elapsed: float, **tags) -> None:
        if self.tracer is not None:
            self.tracer.add(name, elapsed, **tags)
        else:
            self.timer.add(name, elapsed)

    def start(self, epoch: int | None = None) -> None:
        """Re-anchor the clock at fit start; ``epoch`` (a resumed run's)
        also anchors the step baseline."""
        self._t = time.perf_counter()
        if epoch is not None:
            self._last_epoch = epoch
            self._baseline_known = True

    def pre(self, trainer, states, epoch: int) -> None:
        block_until_ready(states.params if hasattr(states, "params") else states)
        now = time.perf_counter()
        elapsed = now - self._t
        self._t = now
        self._add("chunk", elapsed, epoch=int(epoch))
        if self.telemetry is not None and self._baseline_known:
            steps = max(epoch - self._last_epoch, 0) * self.steps_per_epoch
            self.telemetry.chunk(epoch=epoch, steps=steps, seconds=elapsed,
                                 memory=device_memory_stats(), host_memory=host_memory_stats())
        self._baseline_known = True
        self._last_epoch = epoch
        if self.tracer is not None:
            self._open = self.tracer.begin("instrumentation", epoch=int(epoch))

    def post(self, trainer, states, epoch: int) -> None:
        now = time.perf_counter()
        elapsed = now - self._t
        self._t = now
        if self.tracer is not None and self._open is not None:
            self.tracer.end(self._open)
            self._open = None
        else:
            self.timer.add("instrumentation", elapsed)
        if self.telemetry is not None:
            self.telemetry.hook(name="checkpoint_instrumentation", epoch=epoch, seconds=elapsed)
