"""Fleet run registry: an append-only index of every run under a runs root
(counterpart of ``dib_tpu/telemetry/registry.py``).

A single run's events.jsonl answers "what happened in THIS run"; nothing
so far answered "what runs exist, and how has performance moved across
them" — the cross-run trajectory the MFU push and the serving scale-up
campaigns gate against. This module maintains ``<runs_root>/index.jsonl``:
one JSON line per registration, append-only with the same one-``os.write``
durability contract as the event stream. A run registered twice (resumed,
re-summarized) is superseded by its LATEST line — readers fold by
``run_id``, so the file never needs rewriting.

Entry kinds:

  - ``run``   — a training/serving run directory: ``run_id``, status
    (incl. ``preempted``/``incomplete``), headline metrics at run_end
    (steps/s, finals, MFU, serving p99, mitigation/alert counts), and
    provenance (git SHA, device, config hash).
  - ``bench`` — one ``bench.py`` invocation's headline numbers (projected
    minutes, steps/s, MFU, ``vs_baseline``); ``telemetry runs trajectory``
    renders these as the fleet's perf trajectory, and the index report
    charts them.

CLI surface (``python -m dib_tpu_torch telemetry runs ...``)::

    telemetry runs list   [--runs-root R]          # latest entry per run
    telemetry runs show   <run_id> [--runs-root R] # full entry (+history)
    telemetry runs trajectory [--runs-root R]      # bench perf trajectory
    telemetry report --index  [--runs-root R]      # multi-run HTML page

The runs root resolves from ``--runs-root``, else ``DIB_RUNS_ROOT``, else
``./runs`` — the repo's committed runs directory, whose ``index.jsonl``
seeds the trajectory from the committed BENCH_* history.

Host-side file analysis only: this module never imports torch.
"""

from __future__ import annotations

import json
import os
import sys
import time

__all__ = ["INDEX_FILENAME", "RunRegistry", "bench_entry",
           "register_drill_record", "register_run", "resolve_runs_root",
           "run_entry", "runs_main", "validate_index_entry"]

INDEX_FILENAME = "index.jsonl"
INDEX_VERSION = 1

_RUN_METRIC_KEYS = (
    "steps_per_s", "steady_steps_per_s", "final_loss", "final_val_loss",
    "final_total_kl", "final_mi_lower_bits_mean", "mfu", "wall_clock_s",
    "total_steps", "launches", "mitigations_total", "heartbeat_max_gap_s",
)
_PROVENANCE_KEYS = ("git_sha", "device_kind", "device_platform",
                    "device_count", "process_count", "config_hash")


def resolve_runs_root(root: str | None = None) -> str | None:
    """``--runs-root`` flag > ``DIB_RUNS_ROOT`` env > ``./runs``. An empty
    string at any level disables registration (returns None)."""
    if root is None:
        root = os.environ.get("DIB_RUNS_ROOT")
    if root is None:
        root = "runs"
    return root or None


class RunRegistry:
    """The append-only ``index.jsonl`` under one runs root."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, INDEX_FILENAME)

    # ------------------------------------------------------------- write
    def append(self, entry: dict) -> dict:
        """Append one entry (one durable ``os.write``); stamps the index
        schema version and the registration time."""
        record = {"v": INDEX_VERSION,
                  "t": round(time.time(), 3),   # timing-ok: registration
                  # timestamp, not a measured interval
                  **entry}
        os.makedirs(self.root, exist_ok=True)
        line = json.dumps(record, default=str, allow_nan=False) + "\n"
        fd = os.open(self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                     0o644)
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)
        return record

    # -------------------------------------------------------------- read
    def entries(self) -> list[dict]:
        """All parseable entries, file order. A torn final line (writer
        killed mid-append) is skipped, same as the event stream."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return []
        out = []
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(parsed, dict):
                out.append(parsed)
        return out

    def latest(self) -> dict[str, dict]:
        """run_id -> the LATEST entry for it (append-only supersede)."""
        out: dict[str, dict] = {}
        for entry in self.entries():
            if entry.get("kind") == "run" and entry.get("run_id"):
                out[entry["run_id"]] = entry
        return out

    def history(self, run_id: str) -> list[dict]:
        return [e for e in self.entries() if e.get("run_id") == run_id]

    def bench_history(self) -> list[dict]:
        """Bench entries in file order — the fleet's perf trajectory."""
        return [e for e in self.entries() if e.get("kind") == "bench"]


# ----------------------------------------------------------------- entries
def _lineage_from_stream(run_dir: str) -> dict | None:
    """The run's causal lineage — the first ``ctx`` envelope its event
    stream carries (``telemetry/context.py``): ``{"trace_id", "parent",
    "origin"}``. None for pre-tracing streams (absence stays absent —
    the registry never invents lineage)."""
    from dib_tpu_torch.telemetry.events import read_events

    try:
        for event in read_events(run_dir):
            ctx = event.get("ctx")
            if isinstance(ctx, dict) and ctx.get("trace_id"):
                return {k: ctx[k] for k in ("trace_id", "parent", "origin")
                        if k in ctx}
    except OSError:
        pass
    return None


def run_entry(run_dir: str, summary: dict | None = None,
              extra: dict | None = None) -> dict:
    """Registry entry for a run directory, from its stream's summary."""
    if summary is None:
        from dib_tpu_torch.telemetry.summary import summarize

        summary = summarize(run_dir)
    metrics = {k: summary[k] for k in _RUN_METRIC_KEYS if k in summary
               and summary[k] is not None}
    serving = summary.get("serving") or {}
    if serving.get("request_p99_ms") is not None:
        metrics["serving_p99_ms"] = serving["request_p99_ms"]
        metrics["requests_per_s"] = serving.get("requests_per_s")
    alerts = summary.get("alerts") or {}
    if alerts.get("count"):
        metrics["alerts"] = alerts["count"]
    transitions = summary.get("transitions") or {}
    if transitions.get("count"):
        metrics["transitions"] = transitions["count"]
    faults = summary.get("faults") or {}
    if faults.get("injected"):
        metrics["faults_injected"] = faults["injected"]
        metrics["faults_undetected"] = len(faults.get("undetected") or [])
    entry = {
        "kind": "run",
        "run_id": summary.get("run_id") or os.path.basename(
            os.path.normpath(run_dir)),
        "run_dir": run_dir,
        "status": summary.get("status", "incomplete"),
        "metrics": metrics,
        "provenance": {k: summary[k] for k in _PROVENANCE_KEYS
                       if k in summary},
    }
    lineage = _lineage_from_stream(run_dir)
    if lineage:
        entry["lineage"] = lineage
    if extra:
        entry.update(extra)
    return entry


def register_run(run_dir: str, root: str | None = None,
                 summary: dict | None = None,
                 extra: dict | None = None) -> dict | None:
    """Summarize ``run_dir`` and append its entry under the runs root.

    Returns the appended record, or None when registration is disabled
    (empty root) or the run dir has no readable stream — a missing
    registry must never fail the run it was meant to record, so errors
    degrade to a warning.
    """
    root = resolve_runs_root(root)
    if not root:
        return None
    import warnings

    try:
        entry = run_entry(run_dir, summary=summary, extra=extra)
        return RunRegistry(root).append(entry)
    except (OSError, ValueError) as exc:
        warnings.warn(f"run registry: could not register {run_dir!r} "
                      f"under {root!r}: {exc}")
        return None


def bench_entry(record: dict, extra: dict | None = None) -> dict:
    """Registry entry from a ``bench.py`` JSON line (fresh or degraded)."""
    entry = {
        "kind": "bench",
        "metric": record.get("metric"),
        "value": record.get("value"),
        "unit": record.get("unit"),
    }
    for key in ("vs_baseline", "steps_per_s", "mfu", "achieved_tflops",
                "device_kind", "compile_cache", "degraded", "measured_at",
                "stale_seconds", "cache_measured_at"):
        if record.get(key) is not None:
            entry[key] = record[key]
    telemetry = record.get("telemetry") or {}
    if telemetry.get("run_id"):
        entry["run_id"] = telemetry["run_id"]
    if extra:
        entry.update(extra)
    return entry


def register_drill_record(record: dict, root: str | None = None,
                          extra: dict | None = None) -> dict | None:
    """Register a drill-matrix record (fault_drill / chaos_suite) as a
    bench entry, so ``telemetry runs trajectory`` carries the robustness
    history alongside the perf history. Only under an EXPLICIT root
    (``root`` argument or ``DIB_RUNS_ROOT``) — never the ``./runs``
    default, because ad-hoc local drill runs must not grow the committed
    index. Returns the appended entry, or None when no explicit root is
    configured."""
    root = root or os.environ.get("DIB_RUNS_ROOT")
    if not root:
        return None
    entry = bench_entry(record, extra={
        "total": record.get("total"),
        "all_passed": record.get("all_passed"),
        **(extra or {}),
    })
    return RunRegistry(root).append(entry)


# -------------------------------------------------------------- validation
def validate_index_entry(entry) -> list[str]:
    """Schema problems for one index line (``scripts/check_run_artifacts``
    runs this over the committed ``runs/index.jsonl``)."""
    problems: list[str] = []
    if not isinstance(entry, dict):
        return ["entry must be an object"]
    if entry.get("v") != INDEX_VERSION:
        problems.append(f"'v' must be {INDEX_VERSION}")
    t = entry.get("t")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or t != t:
        problems.append("'t' must be a finite unix timestamp")
    kind = entry.get("kind")
    if kind == "run":
        if not (isinstance(entry.get("run_id"), str) and entry["run_id"]):
            problems.append("run entry: 'run_id' must be a non-empty string")
        if not (isinstance(entry.get("status"), str) and entry["status"]):
            problems.append("run entry: 'status' must be a non-empty string")
        if not isinstance(entry.get("metrics"), dict):
            problems.append("run entry: 'metrics' must be an object")
    elif kind == "bench":
        if not (isinstance(entry.get("metric"), str) and entry["metric"]):
            problems.append("bench entry: 'metric' must be a non-empty "
                            "string")
        value = entry.get("value")
        ok_value = (isinstance(value, (int, float))
                    and not isinstance(value, bool) and value == value)
        if not ok_value and not entry.get("degraded"):
            problems.append("bench entry: 'value' must be a finite number "
                            "(or the entry marked 'degraded')")
    else:
        problems.append(f"unknown entry kind {kind!r} "
                        "(expected 'run' or 'bench')")
    return problems


# --------------------------------------------------------------------- CLI
def _fmt(v, width: int | None = None) -> str:
    if v is None:
        s = "—"
    elif isinstance(v, float):
        s = f"{v:.4g}"
    else:
        s = str(v)
    return s if width is None else s[:width].ljust(width)


def runs_main(args) -> int:
    """``telemetry runs list|show|trajectory`` (parsed args from
    summary.telemetry_main)."""
    root = resolve_runs_root(args.runs_root)
    if not root:
        print("telemetry runs: no runs root (set --runs-root or "
              "DIB_RUNS_ROOT)", flush=True)
        return 2
    registry = RunRegistry(root)
    if args.runs_action == "list":
        latest = registry.latest()
        if not latest:
            print(f"no runs registered under {registry.path}")
            return 0
        print(f"{'run_id':32} {'status':11} {'device':14} "
              f"{'steps/s':>9} {'mfu':>7} {'alerts':>6} "
              f"{'lineage':22}  run_dir")
        for run_id, entry in sorted(
                latest.items(), key=lambda kv: kv[1].get("t", 0.0)):
            metrics = entry.get("metrics") or {}
            prov = entry.get("provenance") or {}
            lineage = entry.get("lineage") or {}
            # the trace_id, or the parent study when one is named — the
            # cross-plane join key `telemetry fleet` merges on
            trace = lineage.get("parent") or lineage.get("trace_id")
            print(f"{_fmt(run_id, 32)} {_fmt(entry.get('status'), 11)} "
                  f"{_fmt(prov.get('device_kind'), 14)} "
                  f"{_fmt(metrics.get('steps_per_s')):>9} "
                  f"{_fmt(metrics.get('mfu')):>7} "
                  f"{_fmt(metrics.get('alerts', 0)):>6} "
                  f"{_fmt(trace, 22)}  "
                  f"{entry.get('run_dir', '—')}")
        return 0
    if args.runs_action == "show":
        history = registry.history(args.run_id)
        if not history:
            print(f"telemetry runs show: no entry for {args.run_id!r} "
                  f"in {registry.path}", flush=True)
            return 2
        latest_entry = history[-1]
        lineage = latest_entry.get("lineage") or {}
        if lineage.get("trace_id"):
            # the human-readable origin chain rides stderr: stdout stays
            # pure JSON (the entry itself carries the lineage block) so
            # `runs show <id> | jq` keeps working on traced runs
            origin = " → ".join(lineage.get("origin") or ()) or "—"
            print(f"lineage: trace {lineage['trace_id']}  "
                  f"parent {lineage.get('parent') or '—'}  "
                  f"origin {origin}", file=sys.stderr)
        print(json.dumps(latest_entry if not args.full_history else history,
                         indent=1))
        return 0
    # trajectory
    bench = registry.bench_history()
    if not bench:
        print(f"no bench entries under {registry.path} — run bench.py "
              "(it registers every invocation) or seed from committed "
              "artifacts")
        return 0
    print(f"{'#':>3} {'measured_at':20} {'value':>9} {'unit':9} "
          f"{'steps/s':>9} {'mfu':>8} {'vs_baseline':>11} {'stale':>9}  "
          "device")
    for i, entry in enumerate(bench):
        # stale_seconds: how old the SERVED value was at emission time (a
        # cached value rides degraded records); fresh measurements have
        # none and print "—"
        stale = entry.get("stale_seconds")
        stale_s = "—" if stale is None else f"{int(stale)}s"
        print(f"{i:>3} {_fmt(entry.get('measured_at'), 20)} "
              f"{_fmt(entry.get('value')):>9} "
              f"{_fmt(entry.get('unit'), 9)} "
              f"{_fmt(entry.get('steps_per_s')):>9} "
              f"{_fmt(entry.get('mfu')):>8} "
              f"{_fmt(entry.get('vs_baseline')):>11} "
              f"{stale_s:>9}  "
              f"{_fmt(entry.get('device_kind'))}"
              + ("  [degraded]" if entry.get("degraded") else ""))
    return 0
