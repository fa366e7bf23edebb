"""Preemption-tolerant training: SIGTERM grace handling and a distinct exit
(counterpart of ``dib_tpu/train/preempt.py``).

  - :class:`PreemptionGuard` arms SIGTERM/SIGINT handlers that only set a
    flag (plus a grace-deadline abort thread). ``DIBTrainer.fit`` and
    ``BetaSweepTrainer.fit`` check the flag before each chunk, as the JAX
    package's fit does: the chunk in flight finishes, a final chunk-aligned
    checkpoint is written through the fit's checkpoint hook, and
    :class:`TrainingPreempted` unwinds the fit. A notice pending before the
    first chunk stops the fit at once; one that arrives during the last
    chunk lets the run complete.
  - The CLI turns :class:`TrainingPreempted` into a run summary that says
    so and exits with :data:`PREEMPT_EXIT_CODE` (75, ``EX_TEMPFAIL``).
  - If the chunk in flight cannot finish inside the grace budget, the
    guard's abort thread exits the process with the same code anyway; the
    previous chunk-aligned checkpoint is then the resume point.

With telemetry, the boundary path writes a ``preempt_checkpoint``
mitigation, and ``on_grace_expired`` lets the CLI end the event stream
before the grace abort's hard exit.
"""

from __future__ import annotations

import os
import signal
import threading
import time

__all__ = ["PREEMPT_EXIT_CODE", "PreemptionGuard", "TrainingPreempted",
           "chunk_aligned_preempt_exit"]

# EX_TEMPFAIL, "try again later": the worker checkpointed and got out of the
# way; it did not crash.
PREEMPT_EXIT_CODE = 75
_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class TrainingPreempted(Exception):
    """Raised by ``fit`` at a chunk boundary after a preemption signal;
    carries the chunk-aligned ``epoch`` of the final checkpoint
    (``checkpoint_saved`` says whether the hooks held a checkpointer)."""

    def __init__(self, epoch: int, signum: int | None = None, checkpoint_saved: bool = False):
        self.epoch = int(epoch)
        self.signum = signum
        self.checkpoint_saved = bool(checkpoint_saved)
        name = signal.Signals(signum).name if signum is not None else "preemption"
        super().__init__(
            f"training preempted ({name}) at chunk-aligned epoch {epoch}"
            + ("; final checkpoint written" if checkpoint_saved
               else "; no checkpointer in the hook list"))


class PreemptionGuard:
    """Arms SIGTERM/SIGINT for a cooperative chunk-aligned shutdown::

        with PreemptionGuard(grace_s=30.0) as guard:
            trainer.fit(generator, hooks=[...], hook_every=100, preempt=guard)

    The handler only sets ``requested`` and starts a daemon abort thread;
    the fit notices the flag at the next chunk boundary. If no boundary
    comes within ``grace_s``, the abort thread calls
    ``os._exit(PREEMPT_EXIT_CODE)``.
    A second signal during the grace window exits at once. Arming from a
    thread other than the main one does nothing (``signal.signal``
    refuses); :meth:`request` then sets the flag directly.
    ``on_grace_expired`` runs (best effort) just before the grace abort's
    exit.
    """

    def __init__(self, grace_s: float = 30.0, on_grace_expired=None):
        self.grace_s = float(grace_s)
        self.on_grace_expired = on_grace_expired
        self._deadline: float | None = None
        self.signum: int | None = None
        self._requested = threading.Event()
        self._resolved = threading.Event()    # cancels the grace abort
        self._prev_handlers: dict = {}

    def __enter__(self) -> "PreemptionGuard":
        for sig in _SIGNALS:
            try:
                if signal.getsignal(sig) is signal.SIG_IGN:
                    continue            # a shielded (nohup'd) run keeps its protection
                self._prev_handlers[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):   # not the main thread
                pass
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._resolved.set()
        for sig, handler in self._prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()

    def _handle(self, signum, frame) -> None:
        if self._requested.is_set():
            os._exit(PREEMPT_EXIT_CODE)        # second signal in the grace window
        self.request(signum)

    def request(self, signum: int | None = None) -> None:
        """Mark preemption requested (the handler's body; tests call it)."""
        self.signum = signum
        self._deadline = time.monotonic() + self.grace_s
        self._requested.set()
        threading.Thread(target=self._abort_after_grace, daemon=True,
                         name="preempt-grace-abort").start()

    def _abort_after_grace(self) -> None:
        if self._resolved.wait(self.grace_s):
            return
        if self.on_grace_expired is not None:
            try:
                self.on_grace_expired()
            except Exception:       # a best-effort flush before a hard exit
                pass
        os._exit(PREEMPT_EXIT_CODE)

    def remaining_s(self) -> float | None:
        """Seconds left of the grace budget (None before a request)."""
        if self._deadline is None:
            return None
        return round(max(self._deadline - time.monotonic(), 0.0), 3)

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def resolved(self) -> None:
        """Cancel the grace abort (the boundary path finished in time)."""
        self._resolved.set()


def chunk_aligned_preempt_exit(guard, hooks, state, history, generators, chunk: int,
                               telemetry=None):
    """The fits' boundary handler for a pending preemption: saves a final
    chunk-aligned checkpoint through the fit's checkpoint hook (unless this
    boundary's hooks already saved this epoch), writes a
    ``preempt_checkpoint`` mitigation, then raises
    :class:`TrainingPreempted`."""
    from dib_tpu_torch.train.checkpoint import find_checkpointer

    epoch = int(state.epoch)
    ckpt = find_checkpointer(hooks)
    if ckpt is not None and ckpt.latest_step != epoch:
        ckpt.save(epoch, state, history, generators, chunk_size=chunk)
    if telemetry is not None:
        telemetry.mitigation(mtype="preempt_checkpoint", epoch=epoch,
                             checkpoint_saved=ckpt is not None,
                             grace_remaining_s=guard.remaining_s())
    guard.resolved()
    raise TrainingPreempted(epoch, guard.signum, checkpoint_saved=ckpt is not None)
