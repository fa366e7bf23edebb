"""The run's event stream: append-only JSONL, one file per run directory
(counterpart of ``dib_tpu/telemetry/events.py``).

Every run appends typed, schema-versioned events to
``<run_dir>/events.jsonl``: ``run_start`` (the provenance manifest),
``chunk`` (one per fit chunk: wall-clock, steps/s, the boundary row,
device and host memory), ``span`` (one closed trace span), ``heartbeat``
(boundary beats and mid-chunk beats from a daemon thread), ``anomaly``,
``mitigation`` (a self-healing action: divergence rollback, sweep
quarantine or ejection, checkpoint fallback, watchdog kill or restart),
``fault`` (one deliberate injection, written before it acts),
``quarantine``, ``mi_bounds``, ``hook``, ``metrics`` and ``run_end``.
:data:`EVENT_SCHEMA` is a copy of the JAX package's vocabulary, so the
port's streams read with the JAX package's tools. The JAX package's
``compile`` event (XLA's cost analysis of the chunk program) has no
counterpart in eager PyTorch: the port never writes one.

Envelope (every line): ``v`` schema version, ``run`` run id, ``proc``
process index, ``seq`` per-writer sequence number, ``t`` unix time,
``mono`` monotonic clock, ``type``, then the record's fields.

Durability: each event is ONE ``os.write`` of one newline-terminated line
on an ``O_APPEND`` descriptor, under a lock shared with the heartbeat
thread, so concurrent writers (a worker, its heartbeat thread, the
watchdog supervisor, a relaunched worker) never interleave bytes; a killed
writer leaves at most one torn line, which :func:`read_events` skips with
a warning. Events are written only at chunk boundaries, on values the
boundary already fetched.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import uuid
import weakref

SCHEMA_VERSION = 1
EVENTS_FILENAME = "events.jsonl"


@dataclasses.dataclass(frozen=True)
class EventKindSpec:
    """One row of the event-schema registry: the field vocabulary of one
    event kind. ``required`` fields are what every record of the kind
    carries; ``optional`` is the documented detail-field vocabulary. The
    rows are a copy of the JAX package's, kind for kind and field for
    field."""

    required: tuple[str, ...]
    optional: tuple[str, ...] = ()
    doc: str = ""


#: Envelope fields every record carries (written by :meth:`EventWriter.emit`
#: itself). ``ctx`` is the trace context (``telemetry/context.py``).
ENVELOPE_FIELDS = ("v", "run", "proc", "seq", "t", "mono", "type", "tags",
                   "ctx")

#: Closed vocabulary for a request's phases, in wire order. Every phase the
#: HTTP server stamps comes from this tuple, and the per-phase histograms
#: are named ``serve.phase.<name>``. A request carries only the phases it
#: traversed (cached hits skip queue and batch; quota and shed rejections
#: skip queue, batch and dispatch).
REQUEST_PHASES = ("read", "parse", "admission", "queue", "batch",
                  "dispatch", "serialize", "write")

#: kind -> field vocabulary, one row per record type.
EVENT_SCHEMA: dict[str, EventKindSpec] = {
    "run_start": EventKindSpec(
        required=("manifest",),
        doc="provenance manifest at (re)launch"),
    "chunk": EventKindSpec(
        required=("epoch", "steps", "seconds"),
        optional=("steps_per_s", "epochs", "loss", "val_loss", "beta",
                  "kl_per_feature", "metric", "val_metric", "memory",
                  "host_memory", "beta_ends", "replica"),
        doc="per-fit-chunk training signal (sweeps carry [R] lists)"),
    "compile": EventKindSpec(
        required=("name", "seconds", "cache"),
        optional=("flops", "bytes_accessed", "optimal_seconds", "epochs",
                  "op", "bucket", "error", "cost_source"),
        doc="executable compile: seconds, cache status, cost analysis"),
    "mitigation": EventKindSpec(
        required=("mtype",),
        optional=("epoch", "chunk", "step", "action", "reason", "error",
                  "restored_epoch", "loss", "val_loss", "kl_per_feature",
                  "replica", "beta_end", "scope", "members", "deleted",
                  "detail", "host", "hosts", "expected", "observed",
                  "launches", "uptime_s", "worker_alive_s", "surface",
                  "skipped_steps", "timeout_s", "grace_s", "exit_code",
                  "signal", "run_id", "replicas", "consecutive_failures",
                  "healthy", "ejected", "batchers_dead",
                  "checkpoint_saved", "grace_remaining_s", "model",
                  "saved_width", "restored_width", "saved_mesh_axes",
                  "mesh_axes", "quarantined", "floor", "parked",
                  "launch", "at_s", "returncode"),
        doc="one self-healing action (watchdog, rollback, serve health; "
            "sweep_reshard / member_backfill carry the mesh-portability "
            "fields: saved/restored sweep widths and mesh axis sizes; "
            "checkpoint_fallback carries `quarantined` — the quarantine "
            "path of the corrupt step, or false when it was kept)"),
    "anomaly": EventKindSpec(
        required=("epoch", "channel", "kind"),
        optional=("value", "zscore", "threshold", "phase", "replica",
                  "beta_end", "action"),
        doc="one boundary anomaly verdict from the β-aware detector "
            "(train/anomaly.py): a non-finite or robust-z-spiking "
            "boundary metric (kind nonfinite/spike) on `channel` "
            "(loss / val_loss / kl/<i> / param_norm), conditioned on "
            "the β-annealing `phase` — emitted BEFORE the rollback/"
            "ejection mitigation it provokes"),
    "quarantine": EventKindSpec(
        required=("step", "reason"),
        optional=("path", "source", "error", "scope", "epoch",
                  "directory", "replica"),
        doc="one checkpoint step moved into its directory's quarantine/ "
            "subdir (train/checkpoint.py): corrupt at restore, flagged "
            "by `ckpt scrub`, or written during an anomalous window — "
            "the step's bytes stay inspectable but no restore or "
            "rollback path can ever select it again"),
    "fault": EventKindSpec(
        required=("kind",),
        optional=("spec", "chunk", "epoch", "replica", "op", "host",
                  "stale_chunk", "detail", "step", "via"),
        doc="one deliberate injection (dib_tpu/faults), pre-execution"),
    "hook": EventKindSpec(
        required=("name", "epoch", "seconds"),
        doc="host-hook wall-clock per invocation"),
    "span": EventKindSpec(
        required=("name", "path", "span", "parent", "seconds"),
        optional=("epoch", "replica", "beta_end", "op", "bucket",
                  "status", "rows", "fill", "queued_s", "padded_rows",
                  "overlapped", "tenant", "cached", "model", "phases"),
        doc="one closed trace span (serving emits request/batch spans; "
            "request spans may carry the tenant label, cached=true for "
            "response-cache hits, the zoo model name, and `phases` — "
            "the per-phase latency anatomy {name: seconds} keyed by "
            "REQUEST_PHASES, whose values sum to `seconds` exactly; "
            "overlapped=true marks a measurement that rode the async "
            "queue — seconds is then the EXPOSED wait, queued_s the "
            "dispatch→ready window)"),
    "mi_bounds": EventKindSpec(
        required=("epoch",),
        optional=("lower_bits", "upper_bits", "beta", "replica",
                  "beta_end", "per_feature", "feature"),
        doc="MI sandwich-bound measurements"),
    "heartbeat": EventKindSpec(
        required=("beat", "epoch", "phase"),
        optional=("intervals_s", "interval_s", "phase_elapsed_s"),
        doc="bounded-interval liveness beat (boundary / chunk / host)"),
    "alert": EventKindSpec(
        required=("rule",),
        optional=("metric", "value", "bound", "budget", "severity",
                  "source", "when", "burn_fast", "burn_slow", "windows_s",
                  "threshold", "reason"),
        doc="one durable SLO violation (telemetry/slo.py); burn-rate "
            "alerts carry the fast/slow window evidence "
            "(telemetry/fleet.py)"),
    "transition": EventKindSpec(
        required=("channel", "epoch", "direction"),
        optional=("kl_before", "kl_after", "beta", "threshold_nats",
                  "replica"),
        doc="info-plane transition: per-channel KL threshold crossing"),
    "job": EventKindSpec(
        required=("job_id", "action"),
        optional=("unit", "units", "betas", "seeds", "beta", "seed",
                  "worker", "retries", "retry_budget", "backoff_s",
                  "reason", "error", "status", "tenant", "study",
                  "priority", "retry_after_s"),
        doc="one β-grid scheduler job transition (dib_tpu/sched): "
            "submitted / unit_done / unit_failed / done / failed / "
            "rejected (admission control: the fleet queue bound refused "
            "the submit; carries tenant + retry_after_s); submitted "
            "jobs carry their fleet identity (tenant / study / "
            "priority)"),
    "lease": EventKindSpec(
        required=("unit", "action"),
        optional=("job_id", "worker", "lease", "expires_s",
                  "queue_wait_s", "attempt", "reason", "tenant"),
        doc="one work-unit lease transition (dib_tpu/sched): granted / "
            "renewed / released / expired / rejected; grants carry the "
            "tenant they bill to under fair-share scheduling"),
    "publish": EventKindSpec(
        required=("publish_id", "step"),
        optional=("path", "round", "beta", "epoch", "seconds"),
        doc="one chunk-aligned checkpoint published by the streaming "
            "trainer (dib_tpu/stream): staged, fsynced, renamed, then "
            "journaled — the record lands only after the checkpoint is "
            "fully durable under its final path"),
    "deploy": EventKindSpec(
        required=("publish_id", "action"),
        optional=("model", "step", "index", "latency_s", "canary_s",
                  "error"),
        doc="one deployer decision on a published checkpoint "
            "(dib_tpu/stream): promoted (canary passed, hot-swapped via "
            "ModelZoo.reload) or rolled_back (canary/restore failed; the "
            "previous checkpoint keeps answering); latency_s is the "
            "publish→serve window the streaming SLO gates"),
    "study": EventKindSpec(
        required=("study_id", "action"),
        optional=("round", "job_id", "betas", "seeds", "units",
                  "estimates", "deltas_decades", "band_nats",
                  "budget_spent", "budget_max", "max_rounds", "verdict",
                  "reason", "tenant", "fleet", "retry_after_s"),
        doc="one closed-loop study-controller transition (dib_tpu/study): "
            "`submit` (a round's job handed to the scheduler — exactly "
            "once, by decided-set replay), `round` (a round's results "
            "collected: per-channel transition-β `estimates`, their "
            "round-over-round `deltas_decades`, the ensemble "
            "`band_nats`, budget spent), and the terminal verdict "
            "actions `converged` / `unconverged` / `no_transitions`; "
            "submit-only rounds carry `fleet` (the shared scheduler "
            "directory) and `tenant`, and an admission-rejected submit "
            "retries after `retry_after_s` (action `admission_wait`)"),
    "drift": EventKindSpec(
        required=("round", "detector"),
        optional=("shift", "threshold", "action", "epoch",
                  "rewind_epoch", "schedule_study"),
        doc="one detected input-distribution drift on the training "
            "stream (dib_tpu/stream): the normalized shift, the "
            "threshold it crossed, and the β response (reanneal/hold); "
            "a re-anneal under an autopilot-applied schedule carries "
            "`rewind_epoch` (the targeted restart point the refreshed "
            "transition-β floor maps to) and `schedule_study` (the "
            "study that produced it)"),
    "autopilot": EventKindSpec(
        required=("action", "round"),
        optional=("study_id", "reason", "verdict", "estimates",
                  "centers", "seed_publish", "schedule",
                  "drift_to_apply_s", "budget_max", "last_study_round"),
        doc="one drift-autopilot decision on a stream drift round "
            "(dib_tpu/autopilot): `intent` (a targeted mini-study "
            "minted for the drift, watch-seeded `centers`), "
            "`submitted` (its config journaled through the study "
            "controller under `budget_max` units), `verdict` (the "
            "study's outcome + refreshed `estimates`), `applied` (the "
            "re-anneal `schedule` + routing metadata durably written; "
            "`drift_to_apply_s` is the drift→apply latency the SLO "
            "gates), `apply_skip`, and `skip` (debounce/breaker/"
            "poison gates; `reason` says which)"),
    "breaker": EventKindSpec(
        required=("action",),
        optional=("consecutive", "threshold", "round", "via", "detail",
                  "job_id", "tenant", "unit", "until"),
        doc="one circuit-breaker transition: `trip` after `consecutive` "
            "failures reached `threshold`, `probe` (one half-open "
            "attempt let through), `reset` (closed again, `via` "
            "probe/operator). The autopilot breaker (dib_tpu/autopilot) "
            "gates drift studies by `round`; the scheduler's per-job "
            "breaker (dib_tpu/sched) quarantines a repeatedly-failing "
            "job — carrying `job_id`/`tenant`/`unit`/`until` — instead "
            "of burning the shared retry budget"),
    "link": EventKindSpec(
        required=("target",),
        optional=("relation", "plane", "source_ref", "detail"),
        doc="one cross-plane causal edge (telemetry/context.py): this "
            "stream's work was caused-by / gated-by / adopted-from the "
            "record named by `target` (plane:record_ref grammar — e.g. "
            "study:<id>, sched:unit:<unit_id>, publish:<publish_id>); "
            "`relation` names the edge kind, `plane` the target's plane, "
            "`source_ref` this side's own record ref — the explicit edges "
            "the fleet aggregator joins beyond the ctx envelope"),
    "metrics": EventKindSpec(
        required=("snapshots",),
        doc="counter/gauge/histogram snapshots"),
    "run_end": EventKindSpec(
        required=("status",),
        optional=("error", "seconds", "epoch", "aborted_chunk",
                  "steps_per_s", "requests", "ejected_replicas",
                  "final_val_loss", "resumed_from_epoch", "minutes"),
        doc="terminal status"),
}


#: The envelope fields every record must carry (``tags`` and ``ctx`` are
#: written only when set).
_REQUIRED_ENVELOPE = ("v", "run", "proc", "seq", "t", "mono", "type")


def _strict() -> bool:
    """``DIB_TELEMETRY_STRICT=1``: :meth:`EventWriter.emit` rejects kinds
    outside :data:`EVENT_SCHEMA` (and span phases outside
    :data:`REQUEST_PHASES`) instead of writing them. Off by default: a run
    never dies on a telemetry typo; the tests and ``chip_smoke.py`` turn it
    on."""
    return os.environ.get("DIB_TELEMETRY_STRICT") == "1"


__all__ = [
    "SCHEMA_VERSION",
    "EVENTS_FILENAME",
    "ENVELOPE_FIELDS",
    "EVENT_SCHEMA",
    "REQUEST_PHASES",
    "EventKindSpec",
    "EventWriter",
    "config_fingerprint",
    "device_memory_stats",
    "finalize_crashed",
    "finalize_open_writers",
    "host_memory_stats",
    "open_writer",
    "read_events",
    "resolve_events_path",
    "runtime_manifest",
    "shared_run_id",
    "validate_event",
]


def validate_event(event: dict, schema: dict | None = None) -> list[str]:
    """What is wrong with one read-back record under ``schema`` (default
    :data:`EVENT_SCHEMA`): an unknown kind, a missing envelope field or a
    missing required field. Empty when the record is valid."""
    schema = EVENT_SCHEMA if schema is None else schema
    kind = event.get("type")
    if kind not in schema:
        return [f"unknown event kind {kind!r}"]
    problems = [f"{kind}: no envelope field {name!r}"
                for name in _REQUIRED_ENVELOPE if name not in event]
    problems += [f"{kind}: no required field {name!r}"
                 for name in schema[kind].required if name not in event]
    return problems


def open_writer(dir_arg: str | None, default_dir: str | None,
                **kwargs) -> "EventWriter | None":
    """The CLI's ``--telemetry-dir`` convention: ``None`` means the default
    directory (``default_dir``), an empty string turns the stream off, any
    other value is the directory. Returns ``None`` when the stream is off."""
    directory = default_dir if dir_arg is None else dir_arg
    if not directory:
        return None
    return EventWriter(directory, **kwargs)


def shared_run_id() -> str:
    """The run id every process of one run writes under:
    ``DIB_TELEMETRY_RUN_ID`` when set (the watchdog supervisor pins it, so
    its mitigations and every relaunched worker share one run), else a
    fresh id."""
    return os.environ.get("DIB_TELEMETRY_RUN_ID") or _new_run_id()


def _new_run_id() -> str:
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()) + "-" + uuid.uuid4().hex[:8]


# Open writers, so an entry point's crash path can end every started run
# with run_end(status="error") (a SIGKILLed worker cannot: the supervisor's
# mitigation events cover that case).
_OPEN_WRITERS: "weakref.WeakSet[EventWriter]" = weakref.WeakSet()


def finalize_open_writers(error: str | None = None) -> list[str]:
    """Emit ``run_end(status="error")`` on every writer whose run started
    but never ended, and close every open writer. Returns the paths a
    terminal record was appended to."""
    paths = []
    for writer in list(_OPEN_WRITERS):
        if writer._fd is None:
            continue
        if writer._started and not writer._ended:
            writer.run_end(status="error", error=error)
            paths.append(writer.path)
        writer.close()
    return paths


def finalize_crashed(exc: BaseException, log=None) -> list[str]:
    """The entry point's except clause: finalize open writers with the
    exception as the error, and ``log`` where each terminal record went."""
    paths = finalize_open_writers(error=f"{type(exc).__name__}: {exc}")
    if log is not None:
        for path in paths:
            log(f"telemetry: crash terminal record appended to {path}")
    return paths


def config_fingerprint(config) -> str:
    """Short stable hash of a config dataclass or dict."""
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _git_sha() -> str | None:
    """SHA of the checkout this code runs from (None outside a checkout)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=here, capture_output=True,
                             text=True, timeout=5)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _package_version(name: str) -> str | None:
    module = sys.modules.get(name)
    if module is None:
        try:
            import importlib

            module = importlib.import_module(name)
        except Exception:
            return None
    return getattr(module, "__version__", None)


def runtime_manifest(config=None, device_info: bool = True, extra: dict | None = None) -> dict:
    """Provenance manifest for a ``run_start`` event: git SHA, Python,
    torch and numpy, argv; with ``device_info`` the CUDA runtime, the
    device count and the first card's ``name, power.limit``
    (``device.card_line``), or the CPU when no card is present.
    ``device_info=False`` touches no device (the watchdog supervisor)."""
    manifest: dict = {
        "git_sha": _git_sha(),
        "python": sys.version.split()[0],
        "versions": {name: _package_version(name) for name in ("torch", "numpy")},
        "argv": list(sys.argv),
    }
    if device_info:
        import torch

        manifest["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            from dib_tpu_torch.device import card_line

            manifest["device_kind"] = torch.cuda.get_device_name(0)
            manifest["device_platform"] = "gpu"
            manifest["device_count"] = torch.cuda.device_count()
            try:
                manifest["card"] = card_line()
            except (OSError, subprocess.SubprocessError):
                manifest["card"] = None
        else:
            manifest["device_kind"] = "cpu"
            manifest["device_platform"] = "cpu"
            manifest["device_count"] = 1
        manifest["process_count"] = 1
    if config is not None:
        if dataclasses.is_dataclass(config) and not isinstance(config, type):
            manifest["config"] = dataclasses.asdict(config)
        elif isinstance(config, dict):
            manifest["config"] = dict(config)
        manifest["config_hash"] = config_fingerprint(config)
    if extra:
        manifest.update(extra)
    return manifest


def device_memory_stats(device=None) -> dict | None:
    """The JAX view of ``torch.cuda.memory_stats``: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit`` and ``largest_alloc_size``;
    None without a card (CPU runs carry host memory only)."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device or torch.cuda.current_device())
    except Exception:
        return None
    out = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(limit.total_memory),
        "largest_alloc_size": int(stats.get("requested_bytes.all.peak", 0)),
    }
    return out


def host_memory_stats() -> dict | None:
    """Host RSS from ``/proc/self/status``: ``{"rss_bytes",
    "peak_rss_bytes"}``; None where it cannot be read."""
    try:
        with open("/proc/self/status") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    out = {}
    keys = {"VmRSS": "rss_bytes", "VmHWM": "peak_rss_bytes"}
    for line in lines:
        name, _, rest = line.partition(":")
        if name in keys:
            parts = rest.split()
            if parts and parts[0].isdigit():
                out[keys[name]] = int(parts[0]) * 1024
    return out or None


class EventWriter:
    """Appends schema-versioned events to ``<directory>/events.jsonl``.

    ``process_index`` is the writer's process (0 for a single process);
    ``tags`` ride every envelope, e.g. ``{"src": "supervisor"}``; ``ctx``
    (a :class:`~dib_tpu_torch.telemetry.context.TraceContext`) defaults to
    the lineage a parent process pinned in the environment.
    """

    def __init__(self, directory: str, run_id: str | None = None, process_index: int = 0,
                 tags: dict | None = None, filename: str = EVENTS_FILENAME, ctx=None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self.run_id = run_id or _new_run_id()
        if ctx is None:
            from dib_tpu_torch.telemetry.context import from_env

            ctx = from_env()
        self.ctx = ctx
        self.process_index = int(process_index)
        self.tags = dict(tags or {})
        self._seq = 0
        self._started = False
        self._ended = False
        # the heartbeat thread writes while the main thread waits on the
        # device: the lock keeps seq gapless and each record one write
        self._lock = threading.Lock()
        self._fd = os.open(self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        _OPEN_WRITERS.add(self)

    # ----------------------------------------------------------- low level
    def emit(self, event_type: str, **data) -> dict:
        """Append one event; returns the record as written. A writer
        another thread already closed drops the event."""
        if _strict() and event_type not in EVENT_SCHEMA:
            raise ValueError(f"unknown event kind {event_type!r} (DIB_TELEMETRY_STRICT=1; "
                             f"known kinds: {sorted(EVENT_SCHEMA)})")
        with self._lock:
            if self._fd is None:
                return {}
            record = {"v": SCHEMA_VERSION, "run": self.run_id, "proc": self.process_index,
                      "seq": self._seq, "t": time.time(), "mono": time.perf_counter(),
                      "type": event_type}
            if self.tags:
                record["tags"] = self.tags
            if self.ctx is not None:
                record["ctx"] = self.ctx.to_dict()
            record.update(data)
            self._seq += 1
            # a diverged run's NaN loss is written as the string "NaN" (and
            # infinities as "Infinity"/"-Infinity"), never as a bare token
            try:
                line = json.dumps(record, default=_json_default, allow_nan=False) + "\n"
            except ValueError:
                record = _sanitize_nonfinite(record)
                line = json.dumps(record, default=_json_default, allow_nan=False) + "\n"
            os.write(self._fd, line.encode())
        return record

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
        _OPEN_WRITERS.discard(self)

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self._started and not self._ended and self._fd is not None:
            self.run_end(status="error", error=f"{exc_type.__name__}: {exc}")
        self.close()

    # -------------------------------------------------------- typed events
    def run_start(self, manifest: dict) -> dict:
        self._started = True
        return self.emit("run_start", manifest=manifest)

    def chunk(self, *, epoch: int, steps: int, seconds: float, **fields) -> dict:
        steps_per_s = steps / seconds if seconds > 0 else None
        return self.emit("chunk", epoch=int(epoch), steps=int(steps),
                         seconds=round(float(seconds), 6),
                         steps_per_s=round(steps_per_s, 3) if steps_per_s else None, **fields)

    def mitigation(self, *, mtype: str, **fields) -> dict:
        return self.emit("mitigation", mtype=mtype, **fields)

    def fault(self, *, kind: str, **fields) -> dict:
        """One deliberate fault injection, written before it acts: a kill
        still leaves its record."""
        return self.emit("fault", kind=kind, **fields)

    def hook(self, *, name: str, epoch: int, seconds: float, **fields) -> dict:
        return self.emit("hook", name=name, epoch=int(epoch), seconds=round(float(seconds), 6),
                         **fields)

    def mi_bounds(self, *, epoch: int, **fields) -> dict:
        return self.emit("mi_bounds", epoch=int(epoch), **fields)

    def heartbeat(self, *, beat: int, epoch: int, phase: str, **fields) -> dict:
        """One liveness beat: ``boundary`` (main thread, at a chunk
        boundary, with trailing ``intervals_s``), or ``chunk``/``host``
        from the heartbeat thread (``interval_s``, ``phase_elapsed_s``)."""
        return self.emit("heartbeat", beat=int(beat), epoch=int(epoch), phase=phase, **fields)

    def anomaly(self, *, epoch: int, channel: str, kind: str, **fields) -> dict:
        """One boundary anomaly verdict (``train/anomaly.py``), written
        before the rollback or ejection it provokes."""
        return self.emit("anomaly", epoch=int(epoch), channel=channel, kind=kind, **fields)

    def quarantine(self, *, step: int, reason: str, **fields) -> dict:
        """One checkpoint step moved into ``quarantine/``."""
        return self.emit("quarantine", step=int(step), reason=reason, **fields)

    def span(self, *, name: str, path: str, span_id: int, parent_id: int | None,
             seconds: float, **fields) -> dict:
        """One closed span (``telemetry/trace.py``): ``span``/``parent`` ids
        rebuild the tree, ``path`` is the full slash path (the NVTX range's
        name)."""
        if _strict() and "phases" in fields:
            bad = set(fields["phases"]) - set(REQUEST_PHASES)
            if bad:
                raise ValueError(f"span phases outside REQUEST_PHASES: {sorted(bad)}")
        return self.emit("span", name=name, path=path, span=int(span_id),
                         parent=parent_id if parent_id is None else int(parent_id),
                         seconds=round(float(seconds), 6), **fields)

    def metrics(self, snapshots) -> dict:
        return self.emit("metrics", snapshots=snapshots)

    def run_end(self, *, status: str = "ok", **fields) -> dict:
        self._ended = True
        return self.emit("run_end", status=status, **fields)


def _json_default(x):
    """Tensors, arrays and numpy scalars -> lists and numbers."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "item"):
        return x.item()
    return str(x)


def _sanitize_nonfinite(x):
    """Non-finite floats -> their float()-parseable string spellings."""
    if hasattr(x, "tolist"):
        x = x.tolist()
    elif hasattr(x, "item"):
        x = x.item()
    if isinstance(x, float) and x != x:
        return "NaN"
    if isinstance(x, float) and x in (float("inf"), float("-inf")):
        return "Infinity" if x > 0 else "-Infinity"
    if isinstance(x, dict):
        return {k: _sanitize_nonfinite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize_nonfinite(v) for v in x]
    return x


def resolve_events_path(path: str) -> str:
    """Accept a run directory or the events file itself."""
    if os.path.isdir(path):
        return os.path.join(path, EVENTS_FILENAME)
    return path


def read_events(path: str, process_index: int | None = None, types=None):
    """Yield the events of an events.jsonl, oldest first.

    Torn lines are skipped anywhere in the file, with one warning: a writer
    killed mid-write leaves one, and the supervisor and the relaunched
    worker go on appending after it. ``process_index`` keeps one process's
    events; ``types`` a set of event types.
    """
    path = resolve_events_path(path)
    if types is not None:
        types = set(types)
    with open(path, "rb") as f:
        raw = f.read()
    torn = 0
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError:
            torn += 1
            continue
        if process_index is not None and event.get("proc") != process_index:
            continue
        if types is not None and event.get("type") not in types:
            continue
        yield event
    if torn:
        import warnings

        warnings.warn(f"{path}: skipped {torn} torn event line(s): a writer was killed "
                      "mid-append")
