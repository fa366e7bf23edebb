"""Stall detection and relaunch (counterpart of ``dib_tpu/train/watchdog.py``).

A CUDA launch cannot be cancelled from inside the process: a chunk wedged
on the device blocks the Python thread in its next synchronisation. So:

  - DETECTION is in the worker and cheap: its fit writes ``boundary``
    heartbeats (on the event stream when one is written, else through
    :class:`HeartbeatHook`, first in the fit's hooks, to a JSON file), each
    after the chunk's device work has finished, with the trailing
    inter-boundary intervals.
  - MITIGATION is in a supervisor process that never touches the device:
    :func:`supervise` launches the worker, and when no boundary beat lands
    within ``max(floor_s, k x the trailing median interval)`` it SIGKILLs
    the worker's process group and relaunches the same command, which
    resumes from its last chunk-aligned checkpoint bit for bit. A worker
    that exits on its own is relaunched too, with a backoff against crash
    loops; one that exits 75 (a cooperative preemption) is relaunched at
    once. Every kill and relaunch is a mitigation in the returned report
    and, with an ``EventWriter``, on the worker's own event stream.

``supervise_pool`` (the scheduler's) waits for ROADMAP.md queue 1, item 6.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from typing import Sequence

from dib_tpu_torch.train.preempt import PREEMPT_EXIT_CODE

__all__ = ["HeartbeatHook", "PREEMPT_EXIT_CODE", "WatchdogConfig", "supervise",
           "supervise_self"]


class HeartbeatHook:
    """Writes an atomic JSON heartbeat at every fit-chunk boundary.

    Place FIRST in the ``fit(hooks=[...])`` list: it waits for the chunk's
    device work itself (a CUDA event on the current stream), so its
    inter-beat interval is the chunk's wall-clock plus the previous
    boundary's hooks, which the supervisor's trailing-median timeout needs.
    The write is a temporary file and ``os.replace``, so the supervisor
    never reads a torn beat.
    """

    def __init__(self, path: str, keep: int = 32):
        self.path = path
        self.keep = keep
        self.beats = 0
        self.intervals: list[float] = []
        self._t = time.time()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def __call__(self, trainer, states, epoch: int) -> None:
        from dib_tpu_torch.utils.profiling import block_until_ready

        block_until_ready(states.params if hasattr(states, "params") else states)
        now = time.time()
        self.intervals.append(round(now - self._t, 2))
        self._t = now
        self.beats += 1
        payload = {
            "pid": os.getpid(),
            "epoch": int(epoch),
            "beat": self.beats,
            "time": now,
            # [0] includes the process's start-up; the supervisor's steady
            # median starts at [1]
            "intervals_s": self.intervals[-self.keep:],
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


@dataclasses.dataclass
class WatchdogConfig:
    """Timeout policy for :func:`supervise`.

    ``first_beat_timeout_s`` covers the worker's start (importing torch,
    the CUDA context, building the kernels) and its first chunk. The
    steady timeout is ``max(floor_s, k x median(intervals[1:]))``.
    """

    first_beat_timeout_s: float = 600.0
    k: float = 3.0
    floor_s: float = 45.0
    poll_s: float = 1.0
    max_restarts: int = 3
    # Crash-loop damping: when a worker dies within ``min_uptime_s`` of its
    # launch (a deterministic early crash, e.g. a poisoned checkpoint or a
    # bad flag — not a mid-run stall), sleep ``restart_backoff_s`` x
    # consecutive-quick-failures before relaunching, so max_restarts buys
    # wall-clock for a transient cause (a full disk) to clear instead of
    # being burned in milliseconds. 0 disables (the default).
    restart_backoff_s: float = 0.0
    min_uptime_s: float = 10.0


def _read_heartbeat(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class _EventStreamBeats:
    """Heartbeat probe over the run's events.jsonl.

    Where the worker writes an event stream the supervisor reads its
    ``heartbeat`` events instead of the side-channel JSON file:
    BOUNDARY beats (emitted after blocking on the chunk's outputs, with
    trailing inter-boundary ``intervals_s``) drive the same trailing-
    median stall timeout as the file probe; mid-chunk beats are surfaced
    as ``worker_alive_s`` so a stall-kill record can say whether the
    process was still breathing when the device stopped progressing.
    """

    def __init__(self, events_path: str):
        from dib_tpu_torch.telemetry.live import StreamFollower

        self._follower = StreamFollower(events_path)
        self._boundary: dict | None = None
        self._last_any_beat_t: float | None = None

    def read(self, min_t: float = 0.0) -> dict | None:
        """The latest boundary beat with ``t >= min_t`` seen so far, as
        the probe dict the supervise loop expects (``epoch`` / ``beat`` /
        ``time`` / ``intervals_s``). ``min_t`` (the launch time) keeps a
        RELAUNCH from crediting the killed worker's final beats — the
        fresh worker must earn its own first beat within the first-beat
        timeout, exactly like the file probe after its unlink."""
        for event in self._follower.poll():
            if event.get("type") != "heartbeat":
                continue
            if event.get("t", 0.0) < min_t:
                continue
            self._last_any_beat_t = event.get("t")
            if event.get("phase") == "boundary":
                self._boundary = {
                    "epoch": event.get("epoch"),
                    "beat": event.get("beat"),
                    "time": event.get("t"),
                    "intervals_s": event.get("intervals_s") or [],
                }
        return self._boundary

    def worker_alive_s(self) -> float | None:
        """Seconds since ANY beat (mid-chunk included) — the process-
        liveness clock, for kill forensics."""
        if self._last_any_beat_t is None:
            return None
        return time.time() - self._last_any_beat_t

    def reset(self) -> None:
        """Per-relaunch reset: drop the dead worker's beats (the stream
        keeps growing — only the follower's rollup state resets)."""
        self._boundary = None
        self._last_any_beat_t = None


def _steady_timeout(intervals: Sequence[float], cfg: WatchdogConfig) -> float:
    steady = list(intervals[1:])
    if not steady:
        # only the compile-laden first beat has landed; the next chunk
        # should be far faster than it, so its own duration is a safe bound
        return max(cfg.floor_s, cfg.k * intervals[0]) if intervals else cfg.first_beat_timeout_s
    return max(cfg.floor_s, cfg.k * statistics.median(steady))


def supervise(
    cmd: Sequence[str],
    heartbeat_path: str,
    config: WatchdogConfig | None = None,
    env: dict | None = None,
    log=lambda msg: print(msg, file=sys.stderr, flush=True),
    telemetry=None,
    events_path: str | None = None,
) -> dict:
    """Run ``cmd`` under stall/crash supervision until it exits 0.

    ``cmd`` must be resumable: relaunching the identical command after a
    SIGKILL must continue from its own checkpoint (``python -m
    dib_tpu_torch train`` does, with ``--checkpoint_dir``).

    ``telemetry`` (an ``EventWriter``, typically appending to the SAME
    events.jsonl the worker writes — O_APPEND keeps the two writers from
    interleaving) mirrors every mitigation onto the event stream as it
    happens, so a run killed mid-flight still carries its kill record.

    ``events_path`` (the worker's events.jsonl) switches LIVENESS to the
    stream's ``heartbeat`` events instead of the side-channel JSON file:
    boundary beats carry the same trailing intervals the file probe did,
    so the stall timeout is the same either way. Mid-chunk beats
    additionally let a
    stall-kill record say whether the worker process was still alive
    (``worker_alive_s``) when device progress stopped.

    Returns a report dict: ``{"returncode", "wall_s", "launches",
    "mitigations": [{"type":
    "stall_kill"|"crash_restart"|"preempt_restart", ...}]}``. A worker
    exiting with ``PREEMPT_EXIT_CODE`` (cooperative preemption,
    train/preempt.py) is relaunched immediately: no backoff, and no
    restart-budget burn while each preemption lands at a LATER epoch than
    the previous one (zero-progress rc-75 loops are budgeted like
    crashes).
    """
    cfg = config or WatchdogConfig()
    mitigations = _mirrored_mitigations(telemetry, log)
    t_start = time.time()
    # The worker runs in its own session (so WE can kill its whole group),
    # which also means it would SURVIVE the supervisor's death — an external
    # SIGTERM/SIGINT to the supervisor must take the worker down with it,
    # or a timed-out supervisor leaves an orphan training against the same
    # checkpoint dir as its replacement.
    current: list[subprocess.Popen | None] = [None]

    def _teardown(signum, frame):
        proc = current[0]
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        try:
            if signal.getsignal(sig) is signal.SIG_IGN:
                continue   # nohup'd/shielded runs keep their protection
            prev_handlers[sig] = signal.signal(sig, _teardown)
        except (ValueError, OSError):   # non-main thread / unsupported
            pass
    try:
        return _supervise_loop(cmd, heartbeat_path, cfg, env, log,
                               mitigations, t_start, current,
                               events_path=events_path)
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        proc = current[0]
        if proc is not None and proc.poll() is None:   # exception path
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def supervise_self(
    worker_prefix: Sequence[str],
    argv: Sequence[str],
    *,
    outdir: str,
    watchdog_flag: str,
    heartbeat_flag: str,
    checkpoint_flag: str,
    heartbeat: str = "",
    checkpoint_dir: str = "",
    config: WatchdogConfig | None = None,
    telemetry=None,
    events_path: str | None = None,
) -> dict:
    """Re-exec the CURRENT command as a supervised worker.

    The wrapper of ``python -m dib_tpu_torch train --watchdog``: strips the
    watchdog flag from ``argv``, defaults the heartbeat/checkpoint paths
    under ``outdir``, injects the two flags if the caller didn't pass them,
    and runs :func:`supervise` on ``worker_prefix + argv``. Returns the
    supervise() report plus the resolved ``heartbeat``/``checkpoint_dir``.
    """
    os.makedirs(outdir, exist_ok=True)
    heartbeat = heartbeat or os.path.join(outdir, "heartbeat.json")
    checkpoint_dir = checkpoint_dir or os.path.join(outdir, "ckpt")
    worker = [a for a in argv if a != watchdog_flag]
    for flag, value in ((heartbeat_flag, heartbeat),
                        (checkpoint_flag, checkpoint_dir)):
        if flag not in worker:
            worker += [flag, value]
    result = supervise(list(worker_prefix) + worker, heartbeat, config,
                       telemetry=telemetry, events_path=events_path)
    result["heartbeat"] = heartbeat
    result["checkpoint_dir"] = checkpoint_dir
    return result


def _mirrored_mitigations(telemetry, log) -> list:
    """A mitigation list that (when telemetry is given) also emits each
    append as a ``mitigation`` event — the supervise()/supervise_pool()
    shared idiom."""
    if telemetry is None:
        return []

    class _MirroredList(list):
        def append(self, item):
            super().append(item)
            try:
                fields = {k: v for k, v in item.items() if k != "type"}
                telemetry.mitigation(mtype=item["type"], **fields)
            except OSError as exc:   # a full disk must not kill recovery
                log(f"watchdog: telemetry write failed: {exc}")

    return _MirroredList()


def _supervise_loop(cmd, heartbeat_path, cfg, env, log, mitigations,
                    t_start, current, events_path=None) -> dict:
    launches = 0
    quick_failures = 0
    free_relaunches = 0   # cooperative preemptions: not crash-budget burn
    prev_preempt_epoch = None   # progress gate between consecutive preempts
    # stream-based liveness: one incremental
    # follower across relaunches — the workers all append to one stream
    events_beats = (_EventStreamBeats(events_path) if events_path else None)
    while True:
        # a stale beat from the previous attempt must not mask a wedged
        # relaunch
        if os.path.exists(heartbeat_path):
            os.unlink(heartbeat_path)
        if events_beats is not None:
            events_beats.reset()
        launches += 1
        proc = subprocess.Popen(list(cmd), env=env, start_new_session=True)
        current[0] = proc
        launched = time.time()
        last_beat: dict | None = None
        last_beat_seen = launched
        killed = False
        while True:
            rc = proc.poll()
            if events_beats is not None:
                beat = events_beats.read(min_t=launched)
            else:
                beat = _read_heartbeat(heartbeat_path)
            if beat is not None and (
                last_beat is None or beat["time"] != last_beat["time"]
            ):
                last_beat = beat
                last_beat_seen = time.time()
            if rc is not None:
                break
            if last_beat is None:
                timeout, ref = cfg.first_beat_timeout_s, launched
            else:
                timeout = _steady_timeout(last_beat["intervals_s"], cfg)
                ref = last_beat_seen
            waited = time.time() - ref
            if waited > timeout:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
                record = {
                    "type": "stall_kill",
                    "launch": launches,
                    "epoch": last_beat["epoch"] if last_beat else None,
                    "beats": last_beat["beat"] if last_beat else 0,
                    "waited_s": round(waited, 1),
                    "timeout_s": round(timeout, 1),
                    "at_s": round(time.time() - t_start, 1),
                }
                if events_beats is not None:
                    alive = events_beats.worker_alive_s()
                    if alive is not None:
                        # device stall vs process wedge: mid-chunk beats
                        # kept landing iff the PROCESS was alive when
                        # boundary progress stopped
                        record["worker_alive_s"] = round(alive, 1)
                mitigations.append(record)
                log(f"watchdog: no heartbeat for {waited:.0f}s "
                    f"(timeout {timeout:.0f}s) — killed pid {proc.pid}, "
                    f"relaunching from checkpoint")
                killed = True
                break
            time.sleep(cfg.poll_s)
        if not killed:
            if rc == 0:
                return {
                    "returncode": 0,
                    "wall_s": round(time.time() - t_start, 1),
                    "launches": launches,
                    "mitigations": mitigations,
                }
            if rc == PREEMPT_EXIT_CODE:
                # Cooperative preemption (train/preempt.py): the worker
                # wrote a chunk-aligned checkpoint and exited on purpose.
                # Relaunch IMMEDIATELY — no crash-loop backoff, and no
                # restart budget burned as long as the worker ADVANCED
                # past the previous preemption's epoch: preemptions are
                # routine on shared pods, crashes are not. A rc-75 with no
                # heartbeat, or repeated preempts pinned at the SAME epoch
                # (e.g. every chunk outliving the grace budget), is a
                # preemption-shaped stall and falls through to the
                # crash-loop accounting below — unbounded zero-progress
                # relaunching must not hide behind the preemption code.
                epoch = last_beat["epoch"] if last_beat else None
                mitigations.append({
                    "type": "preempt_restart",
                    "launch": launches,
                    "epoch": epoch,
                    "beats": last_beat["beat"] if last_beat else 0,
                    "at_s": round(time.time() - t_start, 1),
                })
                log(f"watchdog: worker preempted (rc={rc}) — relaunching "
                    f"immediately from its checkpoint")
                progressed = (last_beat is not None
                              and epoch != prev_preempt_epoch)
                prev_preempt_epoch = epoch
                if progressed:
                    free_relaunches += 1
                    quick_failures = 0
                    continue
            else:
                mitigations.append({
                    "type": "crash_restart",
                    "launch": launches,
                    "returncode": rc,
                    "epoch": last_beat["epoch"] if last_beat else None,
                    "at_s": round(time.time() - t_start, 1),
                })
                log(f"watchdog: worker exited rc={rc} — relaunching from "
                    f"checkpoint")
        if launches - free_relaunches > cfg.max_restarts:
            return {
                "returncode": rc if not killed else None,
                "wall_s": round(time.time() - t_start, 1),
                "launches": launches,
                "mitigations": mitigations,
                "error": f"gave up after {launches} launches",
            }
        # crash-loop damping (see WatchdogConfig): quick deaths back off,
        # anything that survived min_uptime_s resets the counter
        if time.time() - launched < cfg.min_uptime_s:
            quick_failures += 1
            if cfg.restart_backoff_s > 0:
                delay = cfg.restart_backoff_s * quick_failures
                log(f"watchdog: worker died {quick_failures}x within "
                    f"{cfg.min_uptime_s:.0f}s — backing off {delay:.1f}s")
                time.sleep(delay)
        else:
            quick_failures = 0
