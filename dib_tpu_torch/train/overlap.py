"""Overlapped measurement on a side CUDA stream (counterpart of
``dib_tpu/train/overlap.py``).

At a chunk boundary an MI hook with ``overlap=True`` measures a SNAPSHOT of
the model on a second stream and collects the result at the next boundary
(or at the first read of its records), so the measurement runs while the
next chunk trains:

  1. ``snapshot_params`` copies the live weights into a shadow model on the
     training stream (the optimizer's foreach update rewrites the live
     weights in place during the next chunk, so the snapshot is what keeps
     the measurement's inputs fixed; the JAX package's snapshot guards
     against buffer donation the same way);
  2. the side stream waits for the training stream (``wait_stream``), so
     the copy and the rows' upload are done before it reads them;
  3. the hook's encode and ``mi_row_stats`` launch on the side stream (the
     kernel wrappers launch on ``torch.cuda.current_stream``), and the
     results are copied into pinned host memory there;
  4. a ``torch.cuda.Event`` recorded after the copy is what
     :meth:`PendingDispatch.collect` waits for.

Nothing made on the side stream is read on the training stream: the
results cross as host memory. The shadow is rewritten only after the
previous measurement was collected. The hook's draws come from its own
generator, never the trainer's. On the CPU the measurement runs at once
and only its filing waits for the next boundary.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any

import torch

__all__ = ["OverlapRunner", "PendingDispatch", "begin_overlapped", "collect_overlapped",
           "snapshot_params"]


def snapshot_params(model: torch.nn.Module, shadow: torch.nn.Module | None = None):
    """Copy ``model``'s weights into ``shadow`` (a copy of ``model`` made
    here when None) on the current stream, in one foreach copy; returns
    the shadow."""
    if shadow is None:
        return copy.deepcopy(model)
    with torch.no_grad():
        torch._foreach_copy_(list(shadow.parameters()), list(model.parameters()))
    return shadow


@dataclass
class PendingDispatch:
    """One overlapped measurement in flight: ``outputs`` (host tensors,
    ready once ``event`` has completed), ``meta`` for filing the result,
    the dispatch's wall-clock ``token``, and the ``tracer`` bound at
    dispatch (collection may come after the fit's tracer binding ended)."""

    outputs: Any
    meta: dict = field(default_factory=dict)
    token: Any = None
    tracer: Any = None
    event: Any = None

    def collect(self):
        """Wait for the side stream's work and return the outputs."""
        if self.event is not None:
            self.event.synchronize()
        return self.outputs


def begin_overlapped(outputs, *, epoch: int, event=None, **meta) -> PendingDispatch:
    """Record a dispatch: its outputs, its event, the wall-clock anchor of
    ``queued_s`` and the tracer bound now."""
    from dib_tpu_torch.telemetry import trace

    return PendingDispatch(outputs=outputs, meta={"epoch": int(epoch), **meta},
                           token=time.perf_counter(), tracer=trace.current_tracer(),
                           event=event)


def collect_overlapped(pending: PendingDispatch, name: str = "mi_bounds"):
    """Wait for a dispatch and account for it: one span on the dispatch's
    tracer with ``overlapped=True``, ``seconds`` the wait this collection
    exposed and ``queued_s`` the window from dispatch to ready. Returns the
    outputs."""
    t0 = time.perf_counter()
    fetched = pending.collect()
    now = time.perf_counter()
    fields = {"overlapped": True, "epoch": int(pending.meta.get("epoch", 0))}
    if isinstance(pending.token, (int, float)):
        fields["queued_s"] = round(now - pending.token, 4)
    pending.tracer.add(name, now - t0, **fields)
    return fetched


class OverlapRunner:
    """The side stream and the shadow model of one hook."""

    def __init__(self):
        self._shadow = None
        self._shadow_of = None
        self._streams: dict = {}
        self.last_stream = None      # the stream the last measurement ran on

    def snapshot(self, model: torch.nn.Module) -> torch.nn.Module:
        """The shadow of ``model`` holding its current weights (step 1). A
        new shadow's weights are marked used by the side stream once
        (``record_stream``): they are read there until the shadow is
        dropped."""
        if self._shadow_of is not model:
            self._shadow, self._shadow_of = snapshot_params(model), model
            device = next(model.parameters()).device
            if device.type == "cuda":
                for param in self._shadow.parameters():
                    param.record_stream(self.side_stream(device))
        else:
            snapshot_params(model, self._shadow)
        return self._shadow

    def side_stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def launch(self, measure, device: torch.device, *, epoch: int,
               reads=()) -> PendingDispatch:
        """Run ``measure()`` (returning tensors) on the side stream after the
        work queued so far on the training stream; its outputs come back as
        pinned host tensors behind an event (steps 2-4). ``reads``: tensors
        made on the training stream that ``measure`` reads; each is marked
        used by the side stream (``record_stream``), so the caching
        allocator gives none of their memory away before the measurement
        is done. On the CPU it runs at once."""
        if device.type != "cuda":
            self.last_stream = None
            return begin_overlapped([t.detach().clone() for t in measure()], epoch=epoch)
        side = self.side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        for tensor in reads:
            tensor.record_stream(side)
        with torch.cuda.stream(side):
            outputs = measure()
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outputs]
            for target, source in zip(host, outputs):
                target.copy_(source, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        self.last_stream = side
        return begin_overlapped(host, epoch=epoch, event=event)
