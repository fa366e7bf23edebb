"""Wall-clock timing that waits for the device (counterpart of
``dib_tpu/utils/profiling.py``).

CUDA launches are asynchronous, so a ``time.perf_counter()`` delta around a
call measures its launch only. :class:`PhaseTimer` closes a phase after the
work queued for the outputs registered on its handle has finished: it
records a ``torch.cuda.Event`` on each CUDA device's current stream and
waits for it (the counterpart of JAX's ``block_until_ready``). Tensors on
the CPU need no wait. Importing this module touches no device.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

__all__ = ["PhaseTimer", "block_until_ready", "cuda_devices"]


def cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree`` (tensors, modules,
    optimizers' owners, and lists, tuples and dicts of them)."""
    import torch

    devices, pending = set(), [tree]
    while pending:
        item = pending.pop()
        if isinstance(item, torch.Tensor):
            if item.device.type == "cuda":
                devices.add(item.device)
        elif isinstance(item, torch.nn.Module):
            pending.extend(item.parameters())
        elif isinstance(item, dict):
            pending.extend(item.values())
        elif isinstance(item, (list, tuple)):
            pending.extend(item)
        elif hasattr(item, "params"):         # a TrainState
            pending.append(item.params)
    return devices


def block_until_ready(tree):
    """Wait until the work queued on the current stream of every CUDA device
    that holds a tensor of ``tree`` has finished: one event recorded and
    waited for per device. Returns ``tree``."""
    import torch

    for device in cuda_devices(tree):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()
    return tree


class _PhaseHandle:
    """Collects the tensors a phase must wait for before its interval closes."""

    def __init__(self):
        self._outputs: list = []

    def block_on(self, *outputs):
        """Register tensors produced inside the phase; the timer waits for
        them at phase exit so their device time lands in this phase."""
        self._outputs.extend(outputs)
        return outputs[0] if len(outputs) == 1 else outputs


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase, waiting for the device::

        with timer.phase("step") as p:
            p.block_on(trainer.train_step(state, x, y, beta, eps))
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    intervals: dict = field(default_factory=dict)   # per-phase elapsed series

    def add(self, name: str, elapsed: float) -> None:
        """Record an interval measured elsewhere under ``name`` (phases
        whose boundaries are hook calls, not a ``with`` block)."""
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1
        self.intervals.setdefault(name, []).append(elapsed)

    @contextlib.contextmanager
    def phase(self, name: str):
        handle = _PhaseHandle()
        start = time.perf_counter()
        try:
            yield handle
        finally:
            if handle._outputs:
                block_until_ready(handle._outputs)
            self.add(name, time.perf_counter() - start)

    def report(self) -> dict:
        """{phase: {"total_s", "count", "mean_s"}} summary."""
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / self.counts[name], 4),
            }
            for name in self.totals
        }

    def report_json(self) -> str:
        return json.dumps(self.report())
