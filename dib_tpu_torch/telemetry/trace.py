"""Nested spans with one name in three sinks (counterpart of
``dib_tpu/telemetry/trace.py``).

Each closed span becomes a ``span`` event on the run's ``events.jsonl``
(span and parent ids, full slash path), an interval in a
:class:`~dib_tpu_torch.utils.profiling.PhaseTimer` (keyed by the path),
and an NVTX range of the same path around the body, so an Nsight or
``torch.profiler`` timeline shows the device's work under the span that
launched it. Register the span's outputs on the yielded handle
(``handle.block_on(...)``) and the span waits for them before it closes,
so device time lands in the span that queued it.

The nesting stack is per thread, span ids come from a lock, and
``use_tracer(tracer)`` binds the tracer that the module-level
``span(name)`` uses, so code deep in a hook opens spans without a tracer
argument. With no tracer bound, spans time into a process-local timer and
write nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import threading
import time

from dib_tpu_torch.utils.profiling import PhaseTimer, block_until_ready

__all__ = ["SpanHandle", "SpannedHook", "Tracer", "current_tracer", "span", "use_tracer"]


class SpanHandle:
    """What a ``span(...)`` block sees: output registration and late tags."""

    def __init__(self):
        self._outputs: list = []
        self._fields: dict = {}

    def block_on(self, *outputs):
        """Register tensors produced inside the span; the span waits for
        them at exit."""
        self._outputs.extend(outputs)
        return outputs[0] if len(outputs) == 1 else outputs

    def annotate(self, **fields) -> None:
        """Attach fields known only mid-span to the span's event."""
        self._fields.update(fields)


@contextlib.contextmanager
def _nvtx_range(path: str):
    """An NVTX range named ``path`` while a CUDA device is in use; nothing
    when torch was never imported or no card is initialised (the watchdog
    supervisor stays off the device)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        yield
        return
    torch.cuda.nvtx.range_push(path)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


class Tracer:
    """Span factory bound to an optional ``EventWriter`` and ``PhaseTimer``
    (``timer=None`` makes a private one). Share one tracer per run."""

    def __init__(self, telemetry=None, timer: PhaseTimer | None = None):
        self.telemetry = telemetry
        self.timer = timer if timer is not None else PhaseTimer()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._next_id = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        return sid

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        """Open a nested span; yields a :class:`SpanHandle`."""
        stack = self._stack()
        span_id = self._new_id()
        parent_id = stack[-1][1] if stack else None
        path = (stack[-1][0] + "/" if stack else "") + name
        handle = SpanHandle()
        stack.append((path, span_id))
        start = time.perf_counter()
        try:
            with _nvtx_range(path):
                yield handle
        finally:
            # the span pops and records even when the wait raises (an
            # asynchronous device error surfaces there)
            try:
                if handle._outputs:
                    block_until_ready(handle._outputs)
            finally:
                elapsed = time.perf_counter() - start
                stack.pop()
                self._record(name, path, span_id, parent_id, elapsed,
                             {**tags, **handle._fields})

    def add(self, name: str, seconds: float, **tags) -> None:
        """Record an interval measured elsewhere as a span, parented under
        the current span."""
        stack = self._stack()
        parent_id = stack[-1][1] if stack else None
        prefix = stack[-1][0] + "/" if stack else ""
        self._record(name, prefix + name, self._new_id(), parent_id, seconds, tags)

    def begin(self, name: str, **tags) -> tuple:
        """Open a span that a separate call site closes with :meth:`end`;
        spans opened in between parent under it."""
        stack = self._stack()
        span_id = self._new_id()
        parent_id = stack[-1][1] if stack else None
        path = (stack[-1][0] + "/" if stack else "") + name
        stack.append((path, span_id))
        return (name, path, span_id, parent_id, time.perf_counter(), tags)

    def end(self, token: tuple, **fields) -> None:
        """Close a :meth:`begin` span, wherever it sits on the stack."""
        name, path, span_id, parent_id, start, tags = token
        stack = self._stack()
        entry = (path, span_id)
        if entry in stack:
            del stack[stack.index(entry):]
        self._record(name, path, span_id, parent_id, time.perf_counter() - start,
                     {**tags, **fields})

    def _record(self, name, path, span_id, parent_id, seconds, fields):
        self.timer.add(path, seconds)
        if self.telemetry is not None:
            self.telemetry.span(name=name, path=path, span_id=span_id, parent_id=parent_id,
                                seconds=seconds, **fields)


_ACTIVE: contextvars.ContextVar[Tracer | None] = contextvars.ContextVar(
    "dib_tpu_torch_active_tracer", default=None)
_FALLBACK = Tracer()     # duration-only, process-local: span() never fails


def current_tracer() -> Tracer:
    """The tracer bound by the innermost ``use_tracer``, else a
    process-local one that writes nothing."""
    return _ACTIVE.get() or _FALLBACK


@contextlib.contextmanager
def use_tracer(tracer: Tracer | None):
    """Bind ``tracer`` as the context's active tracer (None: no change)."""
    if tracer is None:
        yield
        return
    token = _ACTIVE.set(tracer)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def span(name: str, **tags):
    """``current_tracer().span(name, **tags)``."""
    return current_tracer().span(name, **tags)


class SpannedHook:
    """Runs a fit hook inside a span of the active tracer named ``name``;
    a cadence-gated hook (one with ``fires_at``) that skips an epoch opens
    no span. Other attributes are the wrapped hook's."""

    def __init__(self, name: str, hook):
        self.name = name
        self.hook = hook

    def fires_at(self, epoch: int) -> bool:
        fires_at = getattr(self.hook, "fires_at", None)
        return fires_at(epoch) if fires_at is not None else True

    def __call__(self, trainer, state, epoch: int):
        if not self.fires_at(epoch):
            return
        with span(self.name, epoch=int(epoch)):
            self.hook(trainer, state, epoch)

    def __getattr__(self, attr):
        if attr in ("hook", "name") or attr.startswith("__"):
            raise AttributeError(attr)
        return getattr(self.hook, attr)
