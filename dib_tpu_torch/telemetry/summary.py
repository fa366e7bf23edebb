"""Run summaries and regression gating over an events.jsonl
(counterpart of ``dib_tpu/telemetry/summary.py``).

``summarize`` rolls a run's event stream into one flat record shaped like
the repo's committed bench records (``metric`` / ``value`` / ``unit`` plus
breakdown keys), so the event stream and the historical one-line JSON
artifacts stay comparable. ``compare`` diffs two runs — steps/s, final
losses, MI lower bound, mitigation counts — and reports a regression when
a metric moves past a threshold in its bad direction; the CLI exits
nonzero on regression, making it a perf gate ``bench.py`` and CI can call:

    python -m dib_tpu_torch telemetry summarize <run_dir>
    python -m dib_tpu_torch telemetry compare <run_a> <run_b> --threshold 0.05
    python -m dib_tpu_torch telemetry report <run_dir>      # static HTML report

``summarize`` additionally rolls ``span`` events into per-path totals
(dynamic indices collapsed: ``sweep/replica3/...`` -> ``sweep/replica*/...``),
ranks the top self-time hotspots, and reports device/host memory
high-water marks. Every rollup is a pure function of the stream, so the
port's ``summarize`` gives the JAX package's record for a stream that
either package wrote, with one departure: the JAX record's
``utilization`` block joins cost-analyzed ``compile`` events with a table
of TPU peak rates. The port writes no ``compile`` event (eager PyTorch
compiles no program) and carries no TPU figures, so its record has no
``utilization`` block and no ``mfu`` alias.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import warnings
from math import log
from typing import Sequence

from dib_tpu_torch.telemetry.events import (
    SCHEMA_VERSION,
    _sanitize_nonfinite,
    read_events,
)

__all__ = ["summarize", "compare", "autopilot_rollup", "faults_rollup",
           "mesh_rollup", "overlap_rollup",
           "scheduler_rollup", "serving_rollup", "span_rollup",
           "streaming_rollup", "study_rollup",
           "span_hotspots", "telemetry_main", "integrity_rollup"]

_LN2 = log(2.0)


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def _as_floats(value) -> list[float]:
    """Flatten a scalar / list / nested list event field to floats.

    Strings parse through ``float()`` — the event writer encodes a
    diverged run's non-finite values as "NaN"/"Infinity" spellings
    (events.py) and they must survive the round trip.
    """
    if value is None:
        return []
    if isinstance(value, (int, float)):
        return [float(value)]
    if isinstance(value, str):
        try:
            return [float(value)]
        except ValueError:
            return []
    out = []
    for v in value:
        out.extend(_as_floats(v))
    return out


# one wire format for non-finite floats, shared with the writer side
# (events.py) so the round-trip cannot drift
_enc = _sanitize_nonfinite


def _normalize_span_path(path: str) -> str:
    """Collapse dynamic trailing indices so per-instance span names roll up:
    ``sweep/replica3/chunk12/mi_bounds`` -> ``sweep/replica*/chunk*/mi_bounds``.
    Only a segment's TRAILING digit run is dynamic by convention."""
    return "/".join(
        re.sub(r"\d+$", "*", seg) for seg in path.split("/")
    )


def span_rollup(span_events) -> dict:
    """{normalized path: {"total_s", "count", "mean_s"}} over span events,
    ordered by total descending."""
    totals: dict[str, list] = {}
    for e in span_events:
        path = _normalize_span_path(e.get("path") or e.get("name") or "?")
        entry = totals.setdefault(path, [0.0, 0])
        entry[0] += e.get("seconds") or 0.0
        entry[1] += 1
    return {
        path: {
            "total_s": round(total, 4),
            "count": count,
            "mean_s": round(total / count, 4) if count else 0.0,
        }
        for path, (total, count) in sorted(
            totals.items(), key=lambda kv: -kv[1][0]
        )
    }


def span_hotspots(rollup: dict, n: int = 3) -> list[dict]:
    """Top-``n`` spans by SELF time (own total minus its children's) —
    total time would double-charge every parent for its children. A child
    is any path whose NEAREST present ancestor in the rollup is this one
    (slash-named spans may skip intermediate levels)."""
    child_s: dict[str, float] = {}
    for path, stats in rollup.items():
        parts = path.split("/")
        for i in range(len(parts) - 1, 0, -1):
            ancestor = "/".join(parts[:i])
            if ancestor in rollup:
                child_s[ancestor] = child_s.get(ancestor, 0.0) \
                    + stats["total_s"]
                break
    rows = [
        {
            "path": path,
            "self_s": round(
                max(stats["total_s"] - child_s.get(path, 0.0), 0.0), 4),
            "total_s": stats["total_s"],
            "count": stats["count"],
        }
        for path, stats in rollup.items()
    ]
    rows.sort(key=lambda r: -r["self_s"])
    return rows[:n]


def overlap_rollup(span_events) -> dict | None:
    """Measurement-overlap accounting over ``overlapped`` spans
    (docs/performance.md "Overlapped measurement"): an overlapped span's
    ``seconds`` is the EXPOSED wait its collection boundary actually paid
    and ``queued_s`` the dispatch→ready window it rode under other work.
    ``hidden_s`` = queued − exposed (wall-clock the measurement spent in
    flight without the host waiting); ``exposed_frac`` = exposed/queued —
    the number ``compare`` gates (a measurement that starts serializing
    boundaries again shows up as the fraction rising toward 1). None when
    the stream carries no overlapped spans."""
    rows = [e for e in span_events if e.get("overlapped")]
    if not rows:
        return None
    exposed = sum(e.get("seconds") or 0.0 for e in rows)
    queued = sum(e.get("queued_s") or 0.0 for e in rows)
    out = {
        "spans": len(rows),
        "exposed_s": round(exposed, 4),
        "queued_s": round(queued, 4),
        "hidden_s": round(max(queued - exposed, 0.0), 4),
    }
    if queued > 0:
        out["exposed_frac"] = round(min(exposed / queued, 1.0), 6)
    by_name: dict[str, int] = {}
    for e in rows:
        by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"), 0) + 1
    out["by_name"] = by_name
    return out


def _percentile(ordered: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (the histogram
    convention in telemetry/metrics.py)."""
    return ordered[min(int(q * len(ordered)), len(ordered) - 1)]


def serving_rollup(span_events, counters: dict | None = None) -> dict | None:
    """Latency/throughput view of a SERVING stream's ``request``/``batch``
    spans (docs/serving.md): request count + status mix + latency
    percentiles, micro-batch count + mean fill ratio, multi-tenancy and
    cache accounting. ``counters`` is the final ``metrics`` event's
    counter snapshot — the zoo's cache hit/miss/eviction counters ride it
    into ``response_cache``/``exec_cache`` keys. None when the stream
    carries no serving spans (training runs)."""
    requests = [e for e in span_events if e.get("name") == "request"]
    batches = [e for e in span_events if e.get("name") == "batch"]
    if not requests and not batches:
        return None
    out: dict = {}
    if requests:
        latencies = sorted(e.get("seconds") or 0.0 for e in requests)
        statuses: dict[str, int] = {}
        tenants: dict[str, int] = {}
        cached = 0
        for e in requests:
            s = e.get("status", "?")
            statuses[s] = statuses.get(s, 0) + 1
            t = e.get("tenant")
            if t is not None:
                tenants[t] = tenants.get(t, 0) + 1
            if e.get("cached"):
                cached += 1
        span = (max(e.get("mono", 0.0) for e in requests)
                - min(e.get("mono", 0.0) for e in requests))
        out.update({
            "requests": len(requests),
            "rows": int(sum(e.get("rows") or 0 for e in requests)),
            "statuses": statuses,
            "request_p50_ms": round(_percentile(latencies, 0.5) * 1e3, 3),
            "request_p99_ms": round(_percentile(latencies, 0.99) * 1e3, 3),
            "request_mean_ms": round(
                sum(latencies) / len(latencies) * 1e3, 3),
        })
        # The UNCACHED view is what the latency SLO means: cache hits
        # answer from memory in ~µs and quota/shed rejections never
        # dispatch at all — enough of either would drag the blended
        # percentile below what a real dispatch costs and wave a breach
        # past the gate. Always present (= the blended view when nothing
        # is cached/rejected), so serve_uncached_p99_ceiling can gate it.
        uncached = sorted(e.get("seconds") or 0.0 for e in requests
                          if not e.get("cached")
                          and e.get("status") not in ("quota", "shed"))
        if uncached:
            out["uncached_request_p99_ms"] = round(
                _percentile(uncached, 0.99) * 1e3, 3)
        if cached:
            out["cached_requests"] = cached
            out["cache_hit_frac"] = round(cached / len(requests), 6)
        if tenants:
            out["tenants"] = dict(sorted(tenants.items()))
        # quota/shed rejections (server-side spans): the rejection-rate
        # SLO guard reads the fraction — a well-behaved tenant mix must
        # keep 429s bounded (docs/serving.md "Tenancy and quotas")
        quota = statuses.get("quota", 0)
        if quota:
            out["quota_rejected"] = quota
        out["quota_rejected_frac"] = round(quota / len(requests), 6)
        if span > 0:
            out["requests_per_s"] = round(len(requests) / span, 3)
        # Request anatomy: per-phase latency rollup from the spans'
        # `phases` field (docs/observability.md "Request anatomy") — a
        # request carries only the phases it traversed, so counts differ
        # per phase (cache hits skip queue/batch, rejections skip
        # dispatch). `share` is each phase's fraction of total phase
        # time — the number the parse/serialize optimization campaign
        # watches.
        phase_values: dict[str, list[float]] = {}
        for e in requests:
            ph = e.get("phases")
            if not isinstance(ph, dict):
                continue
            for name, dt in ph.items():
                if isinstance(dt, (int, float)):
                    phase_values.setdefault(name, []).append(float(dt))
        if phase_values:
            total_s = sum(sum(v) for v in phase_values.values())
            out["phases"] = {
                name: {
                    "count": len(values),
                    "p50_ms": round(
                        _percentile(sorted(values), 0.5) * 1e3, 4),
                    "p99_ms": round(
                        _percentile(sorted(values), 0.99) * 1e3, 4),
                    "mean_ms": round(
                        sum(values) / len(values) * 1e3, 4),
                    "share": round(sum(values) / total_s, 4)
                    if total_s else 0.0,
                }
                for name, values in sorted(phase_values.items())
            }
    if batches:
        fills = [e.get("fill") for e in batches
                 if isinstance(e.get("fill"), (int, float))]
        out["batches"] = len(batches)
        if fills:
            out["batch_fill_mean"] = round(sum(fills) / len(fills), 4)
    for prefix, key in (("serve.cache.response.", "response_cache"),
                        ("serve.cache.exec.", "exec_cache")):
        stats = {name[len(prefix):]: int(value)
                 for name, value in (counters or {}).items()
                 if name.startswith(prefix)}
        if stats:
            hits, misses = stats.get("hits", 0), stats.get("misses", 0)
            if hits + misses:
                stats["hit_frac"] = round(hits / (hits + misses), 6)
            out[key] = stats
    return out


# Which mitigation mtypes count as DETECTING each injected fault kind
# (dib_tpu/faults). A fault whose detector never fires after it is
# UNDETECTED — `telemetry compare` treats that as a regression: the drill
# proved a recovery path is broken.
_FAULT_DETECTORS: dict[str, tuple[str, ...]] = {
    "stall": ("stall_kill",),
    "kill": ("crash_restart",),
    "nan": ("divergence_rollback", "divergence_detected"),
    "inf": ("divergence_rollback", "divergence_detected"),
    "ckpt_truncate": ("checkpoint_fallback",),
    "ckpt_bitflip_manifest": ("checkpoint_fallback",),
    "replica_error": ("replica_ejected",),
    "replica_slow": ("replica_ejected",),
    "batcher_crash": ("serving_unhealthy", "batcher_restarted"),
    # sweep-level self-healing (docs/robustness.md "Sweep and pod
    # failures"): a poisoned member is detected by its quarantine heal —
    # or, when the divergence is deterministic, by its ejection
    "replica_nan": ("divergence_rollback", "replica_ejected",
                    "divergence_detected"),
    # cooperative preemption: the worker's chunk-aligned grace checkpoint,
    # the supervisor's immediate relaunch, and the scheduler's lease-free
    # re-queue (dib_tpu/sched) all prove detection
    "preempt": ("preempt_checkpoint", "preempt_restart",
                "preempt_requeue"),
    # the multihost barrier emits desync_detected before raising
    "desync": ("desync_detected",),
    # scheduler faults (dib_tpu/sched, docs/robustness.md "Sweep as a
    # service"): a killed worker is detected by the pool's dead-worker
    # steal (worker_dead and/or the lease_stolen it provokes); a forced
    # lease expiry by the steal alone; a torn journal by the restarted
    # scheduler's replay surfacing journal_recovered
    "sched_worker_kill": ("worker_dead", "lease_stolen"),
    "lease_expire": ("lease_stolen",),
    "journal_torn": ("journal_recovered",),
    # streaming control-plane faults (dib_tpu/stream, docs/streaming.md):
    # a trainer SIGKILLed mid-publish is detected by the relaunch
    # resuming from the newest durable publish (stream_resumed) or by the
    # publish journal's torn-line replay; a deployer SIGKILL by the
    # restart's exactly-once catch-up; a poisoned published checkpoint by
    # the canary gate rolling the promotion back
    "stream_mid_publish_kill": ("stream_resumed", "journal_recovered"),
    "stream_deployer_kill": ("deployer_caught_up",),
    "stream_poison": ("canary_rollback",),
    # silent-data-corruption faults (docs/robustness.md
    # "Numerical integrity"): a finite param corruption is detected by
    # the β-aware anomaly detector's rollback (or, if the garbage
    # overflows mid-chunk, by the classic divergence rollback); a
    # flipped payload bit by the content-digest gate's fallback walk on
    # any restore path — or by the deployer's canary refusing the
    # poisoned artifact before it ever answers a request
    "sdc": ("anomaly_rollback", "anomaly_detected",
            "divergence_rollback", "divergence_detected"),
    "replica_sdc": ("anomaly_rollback", "replica_ejected",
                    "anomaly_detected"),
    "ckpt_bitflip_payload": ("checkpoint_fallback", "canary_rollback"),
    # closed-loop study controller (dib_tpu/study, docs/study.md): a
    # controller SIGKILLed inside the exactly-once window (between the
    # round's journal append and the scheduler submit, or between the
    # submit and the journal ack) is detected by the restarted
    # controller's resume — which resolves the unacked round against the
    # scheduler journal instead of blindly resubmitting
    "study_kill": ("study_resumed",),
}

# Recovery markers per kind, evaluated on events AFTER the detection:
# train-scope faults recover when training demonstrably resumes (a chunk
# with finite loss, or a clean run_end); serve-scope faults recover on the
# matching re-admission/recovery mitigation.
_SERVE_RECOVERERS: dict[str, tuple[str, ...]] = {
    "replica_error": ("replica_readmitted",),
    "replica_slow": ("replica_readmitted",),
    "batcher_crash": ("serving_recovered", "batcher_restarted"),
}

# Scheduler faults recover when the queue demonstrably moves again: a
# unit (or the whole job) completing AFTER the detection proves the
# stolen/recovered work actually ran to the end — a clean run_end alone
# would also say so, but the job event is the sharper signal.
_SCHED_FAULT_KINDS = ("sched_worker_kill", "lease_expire", "journal_torn")

# Streaming faults recover when the control plane demonstrably moves
# again AFTER detection: a fresh publish (trainer side) or a promoted
# deploy (deployer side) — the always-on loop's own terminal records.
_STREAM_FAULT_KINDS = ("stream_mid_publish_kill", "stream_deployer_kill",
                       "stream_poison")


def _chunk_loss_finite(event: dict) -> bool:
    vals = _as_floats(event.get("loss"))
    return bool(vals) and all(math.isfinite(v) for v in vals)


def _marks_recovery(kind: str, event: dict) -> bool:
    if kind in _SERVE_RECOVERERS:
        return (event.get("type") == "mitigation"
                and event.get("mtype") in _SERVE_RECOVERERS[kind])
    if kind in _SCHED_FAULT_KINDS:
        return (event.get("type") == "job"
                and event.get("action") in ("unit_done", "done"))
    if kind in _STREAM_FAULT_KINDS:
        return (event.get("type") == "publish"
                or (event.get("type") == "deploy"
                    and event.get("action") == "promoted")
                or (event.get("type") == "run_end"
                    and event.get("status") == "ok"))
    if event.get("type") == "chunk":
        return _chunk_loss_finite(event)
    return (event.get("type") == "run_end"
            and event.get("status") == "ok")


def faults_rollup(events) -> dict | None:
    """Injected vs detected vs recovered over a stream's ``fault`` events.

    Computed over the GLOBAL event list (faults fire in the worker,
    stall/crash mitigations land from the supervisor process — scoping to
    one process would blind the join). Deltas use the wall-clock ``t``
    envelope field, the only clock shared across processes. None when the
    stream carries no injections (normal runs).
    """
    ordered = sorted(events, key=lambda e: e.get("t", 0.0))
    faults = [e for e in ordered if e.get("type") == "fault"]
    if not faults:
        return None
    per_fault = []
    for fault in faults:
        kind = fault.get("kind", "?")
        t0 = fault.get("t", 0.0)
        # An UNREGISTERED kind scores undetected — defaulting to "any
        # later mitigation counts" would let a routine unrelated
        # mitigation wave a genuinely undetected fault past the compare
        # gate. (http_malformed intentionally has no detector: its
        # containment evidence is HTTP status codes, so drills record it
        # in FAULT_DRILL.json rather than as fault events.)
        detectors = _FAULT_DETECTORS.get(kind, ())
        record: dict = {"kind": kind, "spec": fault.get("spec")}

        def _identity_matches(event: dict) -> bool:
            # when BOTH sides name a replica, the join must respect it —
            # replica 0's ejection must not mark replica 1's injected
            # fault "detected" and wave a broken path past the gate
            fr, mr = fault.get("replica"), event.get("replica")
            return fr is None or mr is None or fr == mr

        detection = next(
            (e for e in ordered
             if e.get("t", 0.0) >= t0 and e.get("type") == "mitigation"
             and e.get("mtype") in detectors and _identity_matches(e)),
            None,
        )
        record["detected"] = detection is not None
        if detection is not None:
            record["detected_by"] = detection.get("mtype")
            record["time_to_detect_s"] = round(
                detection.get("t", t0) - t0, 3)
            recovery = next(
                (e for e in ordered
                 if e.get("t", 0.0) >= detection.get("t", t0)
                 and e is not detection and _marks_recovery(kind, e)
                 and _identity_matches(e)),   # replica 0's readmission is
                 # not replica 1's recovery
                None,
            )
            record["recovered"] = recovery is not None
            if recovery is not None:
                record["time_to_recover_s"] = round(
                    recovery.get("t", t0) - t0, 3)
        else:
            record["recovered"] = False
        per_fault.append(record)

    def _stats(key):
        vals = [r[key] for r in per_fault if key in r]
        if not vals:
            return None
        return {"mean": round(sum(vals) / len(vals), 3),
                "max": round(max(vals), 3)}

    by_kind: dict[str, dict] = {}
    for r in per_fault:
        entry = by_kind.setdefault(
            r["kind"], {"injected": 0, "detected": 0, "recovered": 0})
        entry["injected"] += 1
        entry["detected"] += r["detected"]
        entry["recovered"] += r["recovered"]
    rollup = {
        "injected": len(per_fault),
        "detected": sum(r["detected"] for r in per_fault),
        "recovered": sum(r["recovered"] for r in per_fault),
        "undetected": [r["kind"] for r in per_fault if not r["detected"]],
        "by_kind": by_kind,
        "faults": per_fault,
    }
    for key in ("time_to_detect_s", "time_to_recover_s"):
        stats = _stats(key)
        if stats is not None:
            rollup[key] = stats
    return rollup


def scheduler_rollup(events) -> dict | None:
    """Queue-health view of a stream's ``job``/``lease`` events
    (``dib_tpu/sched``): job/unit outcome counts, lease transition
    counts (``leases_expired`` is the SLO ceiling's metric), the worst
    per-unit retry count (``unit_retries_max`` vs the retry-budget
    ceiling), and queue-wait percentiles from lease grants
    (``queue_wait_p99_s`` vs its ceiling — see SLO.json). None when the
    stream carries no scheduler events (ordinary runs).

    Multi-tenant fleets (docs/scheduling.md) additionally get a
    ``tenants`` block (per-tenant job/unit outcomes, admission rejects,
    and queue-wait percentiles), ``admission_rejected`` /
    ``admission_reject_frac`` (rejects over admission attempts — the
    ``sched_admission_reject_ceiling`` SLO metric), and
    ``tenant_wait_p99_ratio`` (worst tenant queue-wait p99 over the
    fleet median — the ``sched_starvation_ceiling`` metric; a fair
    scheduler keeps it near 1 even under a greedy-tenant flood). All
    absent on single-tenant streams whose events carry no tenant.
    """
    jobs = [e for e in events if e.get("type") == "job"]
    leases = [e for e in events if e.get("type") == "lease"]
    if not jobs and not leases:
        return None
    job_actions: dict[str, int] = {}
    for e in jobs:
        a = e.get("action", "?")
        job_actions[a] = job_actions.get(a, 0) + 1
    lease_actions: dict[str, int] = {}
    for e in leases:
        a = e.get("action", "?")
        lease_actions[a] = lease_actions.get(a, 0) + 1
    out: dict = {
        "jobs": {
            "submitted": job_actions.get("submitted", 0),
            "done": job_actions.get("done", 0),
            "failed": job_actions.get("failed", 0),
        },
        "units": {
            "submitted": sum(e.get("units") or 0 for e in jobs
                             if e.get("action") == "submitted"),
            "done": job_actions.get("unit_done", 0),
            "failed_attempts": job_actions.get("unit_failed", 0),
        },
        "leases": lease_actions,
        "leases_expired": lease_actions.get("expired", 0),
        "leases_rejected": lease_actions.get("rejected", 0),
    }
    # `retries` on a unit_failed event is the job's retries_used AFTER
    # that failure, so the max over the stream is the worst per-job spend
    retries = [e.get("retries") for e in jobs
               if e.get("action") == "unit_failed"
               and isinstance(e.get("retries"), (int, float))]
    out["retries_max"] = int(max(retries)) if retries else 0
    waits = sorted(e.get("queue_wait_s") for e in leases
                   if e.get("action") == "granted"
                   and isinstance(e.get("queue_wait_s"), (int, float)))
    if waits:
        out["queue_wait_p50_s"] = round(_percentile(waits, 0.5), 3)
        out["queue_wait_p99_s"] = round(_percentile(waits, 0.99), 3)
        out["queue_wait_max_s"] = round(waits[-1], 3)

    # ---- multi-tenant fleet view (only when events carry tenants)
    tenants: dict[str, dict] = {}

    def tenant_entry(name: str) -> dict:
        return tenants.setdefault(name, {
            "jobs": 0, "units": 0, "units_done": 0, "units_failed": 0,
            "admission_rejected": 0,
        })

    for e in jobs:
        name = e.get("tenant")
        if not name:
            continue
        action = e.get("action")
        if action == "submitted":
            entry = tenant_entry(name)
            entry["jobs"] += 1
            entry["units"] += int(e.get("units") or 0)
        elif action == "unit_done":
            tenant_entry(name)["units_done"] += 1
        elif action == "unit_failed":
            tenant_entry(name)["units_failed"] += 1
        elif action == "rejected":
            tenant_entry(name)["admission_rejected"] += 1
    tenant_waits: dict[str, list[float]] = {}
    for e in leases:
        if (e.get("action") == "granted" and e.get("tenant")
                and isinstance(e.get("queue_wait_s"), (int, float))):
            tenant_waits.setdefault(e["tenant"], []).append(
                float(e["queue_wait_s"]))
    for name, vals in tenant_waits.items():
        vals.sort()
        entry = tenant_entry(name)
        entry["queue_wait_p50_s"] = round(_percentile(vals, 0.5), 3)
        entry["queue_wait_p99_s"] = round(_percentile(vals, 0.99), 3)
    if tenants:
        out["tenants"] = tenants
        rejected = sum(t["admission_rejected"] for t in tenants.values())
        admitted = sum(t["jobs"] for t in tenants.values())
        out["admission_rejected"] = rejected
        out["admission_reject_frac"] = round(
            rejected / max(rejected + admitted, 1), 4)
        p99s = sorted(t["queue_wait_p99_s"] for t in tenants.values()
                      if "queue_wait_p99_s" in t)
        if len(p99s) >= 2:
            median = _percentile(p99s, 0.5)
            out["tenant_wait_p99_ratio"] = round(
                p99s[-1] / max(median, 1e-9), 3)
    return out


def streaming_rollup(events) -> dict | None:
    """Control-plane view of a stream's ``publish``/``deploy``/``drift``
    events (``dib_tpu/stream``, docs/streaming.md). A trainer stream
    carries publishes and drifts; a deployer stream carries deploys —
    the rollup reports whichever are present, and the deploy-side keys
    are what the streaming SLO rules gate: ``publish_to_serve_p50_s``/
    ``publish_to_serve_p99_s`` from each deploy's ``latency_s``,
    ``rollbacks``, and the two journal invariants — ``lost_publishes``
    (a publish index below the newest processed one with no deploy
    decision: the deployer skipped it) and ``double_promotions`` (two
    decisions for one publish id). None when the stream carries no
    streaming events."""
    publishes = [e for e in events if e.get("type") == "publish"]
    deploys = [e for e in events if e.get("type") == "deploy"]
    drifts = [e for e in events if e.get("type") == "drift"]
    if not publishes and not deploys and not drifts:
        return None
    out: dict = {}
    if publishes:
        out["publishes"] = len(publishes)
    if drifts:
        out["drifts"] = len(drifts)
    if deploys:
        out["deploys"] = len(deploys)
        out["promoted"] = sum(e.get("action") == "promoted"
                              for e in deploys)
        out["rollbacks"] = sum(e.get("action") == "rolled_back"
                               for e in deploys)
        latencies = sorted(e.get("latency_s") for e in deploys
                           if isinstance(e.get("latency_s"), (int, float)))
        if latencies:
            out["publish_to_serve_p50_s"] = round(
                _percentile(latencies, 0.5), 3)
            out["publish_to_serve_p99_s"] = round(
                _percentile(latencies, 0.99), 3)
        by_publish: dict[str, int] = {}
        for e in deploys:
            pid = str(e.get("publish_id"))
            by_publish[pid] = by_publish.get(pid, 0) + 1
        out["double_promotions"] = sum(
            1 for c in by_publish.values() if c > 1)
        # lost = a gap in the processed publish-INDEX sequence: the
        # trainer numbers publishes 0, 1, 2, … and deploy events copy the
        # index, so an index missing below the newest decided one means
        # the deployer decided a LATER publish without ever deciding this
        # one — the skip the exactly-once contract forbids. Anchored at
        # the SMALLEST index in view, not 0: a restarted deployer with a
        # fresh telemetry dir only carries events for the publishes it
        # decided this launch (earlier ones live in the prior launch's
        # stream), and the deployer structurally processes in order from
        # the journal head — so indices below the view are decided, not
        # lost, and counting them would page stream_lost_publish_max
        # falsely
        indices = {int(e["index"]) for e in deploys
                   if isinstance(e.get("index"), (int, float))}
        out["lost_publishes"] = (
            max(indices) - min(indices) + 1 - len(indices)
            if indices else 0)
    return out


def study_rollup(events) -> dict | None:
    """Closed-loop study view of a stream's ``study`` events
    (``dib_tpu/study``, docs/study.md): rounds run, units
    submitted/done, the latest transition-β ``estimates`` with their
    round-over-round ``deltas_decades`` and ensemble ``band_nats``, the
    budget accounting, and the terminal ``verdict``. The two derived
    gate keys are what the SLO rows read: ``rounds_over_budget``
    (``study_rounds_ceiling`` — a controller refining past its own round
    budget is a runaway loop) and ``unconverged_full_budget``
    (``study_unconverged_max`` — a study that spent its whole budget
    without the estimates stabilizing needs a human, not more units).
    None when the stream carries no study events (ordinary runs skip
    both rules)."""
    studies = [e for e in events if e.get("type") == "study"]
    if not studies:
        return None
    out: dict = {}
    study_id = next((e.get("study_id") for e in studies
                     if e.get("study_id")), None)
    if study_id is not None:
        out["study_id"] = study_id
    out["rounds"] = sum(1 for e in studies if e.get("action") == "round")
    out["units_submitted"] = sum(
        e.get("units") or 0 for e in studies
        if e.get("action") == "submit")
    # unit completions ride the scheduler's job events on the SAME
    # stream (the controller hands its writer to the scheduler)
    out["units_done"] = sum(
        1 for e in events if e.get("type") == "job"
        and e.get("action") == "unit_done")
    last_round = next((e for e in reversed(studies)
                       if e.get("action") == "round"), None)
    if last_round is not None:
        if last_round.get("estimates"):
            out["estimates"] = last_round["estimates"]
        if last_round.get("deltas_decades"):
            out["deltas_decades"] = last_round["deltas_decades"]
        if last_round.get("band_nats") is not None:
            out["band_nats"] = last_round["band_nats"]
    verdict = next((e for e in reversed(studies)
                    if e.get("action") in ("converged", "unconverged",
                                           "no_transitions")), None)
    if verdict is not None:
        out["verdict"] = verdict["action"]
    spent = next((e.get("budget_spent") for e in reversed(studies)
                  if e.get("budget_spent") is not None), None)
    if spent is not None:
        out["budget_spent"] = spent
    budget_max = next((e.get("budget_max") for e in reversed(studies)
                       if e.get("budget_max") is not None), None)
    if budget_max is not None:
        out["budget_max"] = budget_max
    max_rounds = next((e.get("max_rounds") for e in reversed(studies)
                       if e.get("max_rounds") is not None), None)
    if max_rounds is not None:
        out["max_rounds"] = max_rounds
    out["rounds_over_budget"] = (
        max(out["rounds"] - max_rounds, 0) if max_rounds is not None
        else 0)
    # the gate key is the verdict itself: the controller's _decide ends
    # a study unconverged when it cannot produce a stable localized
    # estimate — budget (rounds/units) exhausted, every unit failed, or
    # refinement saturated with unresolved ensemble disagreement — and
    # all of those need a human before more units are spent
    out["unconverged_full_budget"] = int(
        (verdict or {}).get("action") == "unconverged")
    return out


def autopilot_rollup(events) -> dict | None:
    """Drift-autopilot view of a stream (``dib_tpu/autopilot``,
    docs/streaming.md "Closed loop"): the traffic→drift→study→re-anneal
    control plane's ``autopilot`` + ``breaker`` events folded into the
    counts the SLO rules read. ``duplicate_studies`` (rounds that minted
    more than one study intent) is the exactly-once gate
    (``autopilot_duplicate_study_max``); ``breaker_trips`` feeds
    ``autopilot_breaker_trip_ceiling``; ``drift_to_apply_p99_s`` —
    drift event to re-anneal schedule applied, from the ``applied``
    records' own clocks — feeds ``drift_to_apply_p99_ceiling``. None
    when the stream carries no autopilot activity (ordinary runs skip
    all three rules)."""
    pilots = [e for e in events if e.get("type") == "autopilot"]
    breakers = [e for e in events if e.get("type") == "breaker"]
    if not pilots and not breakers:
        return None
    out: dict = {}
    out["intents"] = sum(1 for e in pilots if e.get("action") == "intent")
    out["studies"] = sum(1 for e in pilots
                         if e.get("action") == "submitted")
    out["applied"] = sum(1 for e in pilots if e.get("action") == "applied")
    skips = [e for e in pilots if e.get("action") == "skip"]
    out["skipped"] = len(skips)
    reasons: dict[str, int] = {}
    for e in skips:
        reason = str(e.get("reason") or "unknown")
        reasons[reason] = reasons.get(reason, 0) + 1
    out["skip_reasons"] = {k: reasons[k] for k in sorted(reasons)}
    # exactly-once gate: every drift round may mint AT MOST one study
    # intent across every restart of the supervisor
    intent_rounds: dict[int, int] = {}
    for e in pilots:
        if e.get("action") == "intent" and e.get("round") is not None:
            idx = int(e["round"])
            intent_rounds[idx] = intent_rounds.get(idx, 0) + 1
    out["duplicate_studies"] = sum(
        1 for n in intent_rounds.values() if n > 1)
    out["breaker_trips"] = sum(1 for e in breakers
                               if e.get("action") == "trip")
    out["breaker_resets"] = sum(1 for e in breakers
                                if e.get("action") == "reset")
    last_flip = next((e for e in reversed(breakers)
                      if e.get("action") in ("trip", "reset")), None)
    out["breaker_open"] = int(
        last_flip is not None and last_flip["action"] == "trip")
    latencies = sorted(
        float(e["drift_to_apply_s"]) for e in pilots
        if e.get("action") == "applied"
        and isinstance(e.get("drift_to_apply_s"), (int, float)))
    if latencies:
        out["drift_to_apply_p50_s"] = _percentile(latencies, 0.50)
        out["drift_to_apply_p99_s"] = _percentile(latencies, 0.99)
    last_applied = next((e.get("round") for e in reversed(pilots)
                         if e.get("action") == "applied"
                         and e.get("round") is not None), None)
    if last_applied is not None:
        out["last_applied_round"] = int(last_applied)
    return out


def integrity_rollup(events) -> dict | None:
    """Numerical-integrity view of a stream (docs/robustness.md
    "Numerical integrity"): the β-aware anomaly
    detector's verdicts (``anomaly`` events), the rollbacks they
    provoked, and every checkpoint step moved to ``quarantine/``
    (``quarantine`` events) — corrupt at restore, flagged by ``ckpt
    scrub``, or written during an anomalous window. ``anomaly_rollbacks``
    is what the ``anomaly_rollback_ceiling`` SLO rule gates. None when
    the stream carries no integrity events (clean runs skip the rule).
    """
    anomalies = [e for e in events if e.get("type") == "anomaly"]
    quarantines = [e for e in events if e.get("type") == "quarantine"]
    mitigations = [e for e in events if e.get("type") == "mitigation"]
    anomaly_rollbacks = [m for m in mitigations
                         if m.get("mtype") == "anomaly_rollback"]
    divergence_rollbacks = [m for m in mitigations
                            if m.get("mtype") == "divergence_rollback"]
    fallbacks = [m for m in mitigations
                 if m.get("mtype") == "checkpoint_fallback"]
    if not anomalies and not quarantines and not anomaly_rollbacks:
        return None
    out: dict = {}
    out["anomalies"] = len(anomalies)
    out["anomaly_channels"] = sorted(
        {str(e.get("channel")) for e in anomalies if e.get("channel")})
    out["anomaly_rollbacks"] = len(anomaly_rollbacks)
    out["divergence_rollbacks"] = len(divergence_rollbacks)
    out["quarantines"] = len(quarantines)
    out["quarantined_steps"] = sorted(
        {int(e["step"]) for e in quarantines
         if isinstance(e.get("step"), (int, float))})
    out["checkpoint_fallbacks"] = len(fallbacks)
    return out


def mesh_rollup(events) -> dict | None:
    """Mesh-execution view of a run (``parallel/sweep.py`` shard_map
    engine + mesh-shape-portable checkpoints, docs/parallelism.md).

    ``axes``/``engine`` come from the run_start provenance manifest
    (``mesh_shape``/``sweep_engine``); ``reshards``/``backfills`` count
    the ``sweep_reshard``/``member_backfill`` mitigations restores emit,
    with each reshard's width/layout transition listed under
    ``reshard_events``. None for runs with neither a mesh manifest nor
    elastic activity — serial runs carry no mesh block.
    """
    out: dict = {}
    for e in events:
        if e.get("type") != "run_start":
            continue
        manifest = e.get("manifest") or {}
        if manifest.get("mesh_shape"):
            out["axes"] = manifest["mesh_shape"]
        if manifest.get("sweep_engine"):
            out["engine"] = manifest["sweep_engine"]
    reshards = [e for e in events if e.get("type") == "mitigation"
                and e.get("mtype") == "sweep_reshard"]
    backfills = [e for e in events if e.get("type") == "mitigation"
                 and e.get("mtype") == "member_backfill"]
    if reshards:
        out["reshards"] = len(reshards)
        out["reshard_events"] = [
            {k: e.get(k) for k in ("saved_width", "restored_width",
                                   "saved_mesh_axes", "mesh_axes")
             if e.get(k) is not None}
            for e in reshards
        ]
    if backfills:
        out["backfills"] = len(backfills)
        out["backfilled_replicas"] = sorted(
            {e.get("replica") for e in backfills
             if e.get("replica") is not None})
    return out or None


def summarize(path: str, process_index: int | None = None,
              run_id: str | None = None) -> dict:
    """Roll an events.jsonl (or its run dir) into one flat summary record.

    A supervised run's stream holds several ``run_start`` events (one per
    watchdog relaunch) plus the supervisor's ``mitigation`` events; the
    summary reports the LAST manifest (the run that finished) and counts
    chunks/steps across all launches — that is the honest end-to-end view
    the watchdog report takes too. ``run_id`` restricts to one run's
    events (for streams several invocations appended to, e.g. a reused
    ``DIB_BENCH_TELEMETRY_DIR``).

    Multihost: in an SPMD run EVERY process emits chunk/mi_bounds events
    for the SAME global training, so with no explicit ``process_index``
    the per-run totals (launches, steps, throughput, finals) are computed
    from the lowest process index present — summing across processes
    would multiply steps/s by ``process_count``. Mitigations and event
    counts stay global.
    """
    events = list(read_events(path, process_index=process_index))
    if run_id is not None:
        events = [e for e in events if e.get("run") == run_id]
    if not events:
        raise ValueError(
            f"{path}: no telemetry events"
            + (f" for run_id {run_id!r}" if run_id is not None else "")
            + " (expected an events.jsonl stream or its run dir)"
        )

    def of_type(t, pool):
        return [e for e in pool if e.get("type") == t]

    mitigations = of_type("mitigation", events)
    per_run = events
    if process_index is None:
        chunk_procs = {e.get("proc", 0) for e in of_type("chunk", events)}
        if len(chunk_procs) > 1:
            lead = min(chunk_procs)
            per_run = [e for e in events if e.get("proc", 0) == lead]
    if not any(e.get("type") for e in events):
        # e.g. a bench one-liner or arbitrary JSON handed to summarize:
        # every line parsed, but nothing is an event
        raise ValueError(
            f"{path}: parsed {len(events)} JSON line(s) but none carry an "
            "event 'type' — not a telemetry stream"
        )
    run_starts = of_type("run_start", per_run)
    chunks = of_type("chunk", per_run)
    compiles = of_type("compile", per_run)
    hooks = of_type("hook", per_run)
    mi_events = of_type("mi_bounds", per_run)
    run_ends = of_type("run_end", per_run)

    total_steps = sum(c.get("steps") or 0 for c in chunks)
    total_chunk_s = sum(c.get("seconds") or 0.0 for c in chunks)
    steps_per_s = total_steps / total_chunk_s if total_chunk_s > 0 else None

    # Steady state excludes each launch's first chunk (compile-laden):
    # walk the stream in order and drop the first chunk after every
    # run_start — robust to whatever other events a launch emits in
    # between, and to (run, seq) collisions across relaunched writers.
    steady = []
    awaiting_first_chunk = False
    for e in per_run:
        if e.get("type") == "run_start":
            awaiting_first_chunk = True
        elif e.get("type") == "chunk":
            if awaiting_first_chunk:
                awaiting_first_chunk = False
            else:
                steady.append(e)
    steady_steps = sum(c.get("steps") or 0 for c in steady)
    steady_s = sum(c.get("seconds") or 0.0 for c in steady)
    steady_steps_per_s = steady_steps / steady_s if steady_s > 0 else steps_per_s

    summary: dict = {
        "metric": "run_telemetry_summary",
        "value": round(steps_per_s, 3) if steps_per_s else None,
        "unit": "steps_per_s",
        "schema_version": SCHEMA_VERSION,
        "num_events": len(events),
        "launches": len(run_starts),
        "num_chunks": len(chunks),
        "total_steps": total_steps,
        "total_chunk_s": round(total_chunk_s, 3),
        "steps_per_s": round(steps_per_s, 3) if steps_per_s else None,
        "steady_steps_per_s": (
            round(steady_steps_per_s, 3) if steady_steps_per_s else None
        ),
        "processes": sorted({e.get("proc", 0) for e in events}),
    }

    runs: list[str] = []
    for e in events:
        if e.get("run") is not None and e["run"] not in runs:
            runs.append(e["run"])
    if len(runs) > 1:
        summary["runs"] = runs
    if run_id is None:
        # Several run_starts are the supervised-run norm (one per watchdog
        # relaunch of the SAME training) and aggregate honestly; several
        # DIFFERENT configs mean independent invocations appended to a
        # reused dir, whose blended totals gate on garbage — scope with
        # run_id (CLI: --run-id).
        hashes = {s.get("manifest", {}).get("config_hash")
                  for s in of_type("run_start", events)}
        hashes.discard(None)
        if len(hashes) > 1:
            warnings.warn(
                f"{path}: {len(runs)} runs with {len(hashes)} distinct "
                "config hashes blended into one summary — pass run_id= "
                "(CLI: --run-id) to scope to one run"
            )

    if run_starts:
        manifest = run_starts[-1].get("manifest", {})
        summary["run_id"] = run_starts[-1]["run"]
        for key in ("git_sha", "device_kind", "device_platform",
                    "device_count", "process_count", "config_hash",
                    "mode"):
            if key in manifest:
                summary[key] = manifest[key]
    if run_starts and run_ends:
        summary["wall_clock_s"] = round(run_ends[-1]["t"] - run_starts[0]["t"], 3)
    # Status comes from the LAST launch's terminal record; a launch that
    # never reached run_end (SIGKILL, still in flight) is visibly
    # "incomplete", never silently "ok" from an earlier launch.
    last_end = None
    if run_starts:
        ends_for_last = [e for e in run_ends
                         if e.get("run") == run_starts[-1]["run"]]
        last_end = ends_for_last[-1] if ends_for_last else None
    elif run_ends:
        last_end = run_ends[-1]
    summary["status"] = (last_end.get("status") if last_end is not None
                         else "incomplete")

    if chunks:
        last = chunks[-1]
        summary["final_epoch"] = last.get("epoch")
        for key in ("loss", "val_loss", "beta"):
            if last.get(key) is not None:
                vals = _as_floats(last[key])
                summary[f"final_{key}"] = _enc(
                    vals[0] if len(vals) == 1 else vals
                )
        kl = _as_floats(last.get("kl_per_feature"))
        if kl:
            summary["final_total_kl"] = _enc(sum(kl))
        elif last.get("kl_total") is not None:
            totals = _as_floats(last["kl_total"])
            summary["final_total_kl"] = _enc(
                totals[0] if len(totals) == 1 else totals
            )

    if mi_events:
        last = mi_events[-1]
        lower = _as_floats(last.get("lower_bits"))
        upper = _as_floats(last.get("upper_bits"))
        if not lower:  # nats-tagged emitters
            lower = [x / _LN2 for x in _as_floats(last.get("lower_nats"))]
            upper = [x / _LN2 for x in _as_floats(last.get("upper_nats"))]
        if lower:
            summary["final_mi_lower_bits_mean"] = _enc(round(_mean(lower), 4))
        if upper:
            summary["final_mi_upper_bits_mean"] = _enc(round(_mean(upper), 4))
        summary["mi_checkpoints"] = len(mi_events)

    counts: dict[str, int] = {}
    for m in mitigations:
        counts[m.get("mtype", "unknown")] = counts.get(m.get("mtype", "unknown"), 0) + 1
    summary["mitigations"] = counts
    summary["mitigations_total"] = len(mitigations)

    # injected-fault drills (dib_tpu/faults): joined over GLOBAL events —
    # faults fire in the worker, stall/crash detections land from the
    # supervisor process
    faults = faults_rollup(events)
    if faults is not None:
        summary["faults"] = faults

    # β-grid scheduler queue health (dib_tpu/sched): job/lease events are
    # global like mitigations — the pool's workers and the supervisor may
    # emit from different processes onto one stream
    sched = scheduler_rollup(events)
    if sched is not None:
        summary["scheduler"] = sched

    # streaming control plane (dib_tpu/stream): publish/deploy/drift
    # events are global for the same reason — a supervised trainer's
    # relaunches and its supervisor share one stream
    streaming = streaming_rollup(events)
    if streaming is not None:
        summary["streaming"] = streaming

    # closed-loop study controller (dib_tpu/study): study events are
    # global like the scheduler's — the controller and the pool workers
    # it drives share one stream
    study = study_rollup(events)
    if study is not None:
        summary["study"] = study

    # drift-autopilot control plane (dib_tpu/autopilot): the supervisor
    # journals exactly-once, but its telemetry is the fleet-visible view
    # the SLO rules gate — intents/applies/breaker flips are global like
    # the study's (the supervisor and its restarts share one stream)
    autopilot = autopilot_rollup(events)
    if autopilot is not None:
        summary["autopilot"] = autopilot

    # mesh execution plane (parallel/sweep.py shard_map engine +
    # mesh-shape-portable checkpoints): axis sizes from the run_start
    # provenance, reshard/backfill mitigations from restores
    mesh = mesh_rollup(events)
    if mesh is not None:
        summary["mesh"] = mesh

    # numerical-integrity plane (train/anomaly.py + the v3 content-digest
    # checkpoints): anomaly verdicts, the rollbacks they provoked, and
    # quarantined checkpoint steps — global like mitigations (a scrub or
    # supervisor may emit onto the worker's stream)
    integrity = integrity_rollup(events)
    if integrity is not None:
        summary["integrity"] = integrity

    if compiles:
        by_cache: dict[str, int] = {}
        for c in compiles:
            by_cache[c.get("cache", "unknown")] = by_cache.get(c.get("cache", "unknown"), 0) + 1
        summary["compile"] = {
            "events": len(compiles),
            "total_s": round(sum(c.get("seconds") or 0.0 for c in compiles), 3),
            "cache": by_cache,
            # hit/miss counters (utils/compile_cache.py statuses): a
            # recompile storm shows up as a miss count out of line with the
            # baseline's, without digging through individual events
            "cache_hits": by_cache.get("warm", 0),
            "cache_misses": (by_cache.get("cold-populating", 0)
                             + by_cache.get("cold", 0)),
        }

    span_events = of_type("span", per_run)
    if span_events:
        rollup = span_rollup(span_events)
        summary["spans"] = rollup
        summary["span_hotspots"] = span_hotspots(rollup)
        # the final metrics event's counters carry the zoo cache stats
        # (snapshots are flat dicts: "counters.serve.cache.response.hits")
        counter_snaps = of_type("metrics", per_run)
        counters = None
        if counter_snaps:
            snaps = counter_snaps[-1].get("snapshots") or []
            if snaps:
                counters = {k[len("counters."):]: v
                            for k, v in snaps[0].items()
                            if k.startswith("counters.")}
        serving = serving_rollup(span_events, counters=counters)
        if serving:
            summary["serving"] = serving
        overlap = overlap_rollup(span_events)
        if overlap:
            summary["overlap"] = overlap
            if overlap.get("exposed_frac") is not None:
                # flat alias the compare gate reads (a regression = the
                # overlapped measurement exposing more of its wall-clock)
                summary["overlap_exposed_frac"] = overlap["exposed_frac"]

    mem_device = [((c.get("memory") or {}).get("peak_bytes_in_use"))
                  for c in chunks]
    # sandboxed kernels hide VmHWM: fall back to the max sampled RSS,
    # which is a chunk-boundary high-water mark of its own
    mem_host = [(c.get("host_memory") or {}).get(
                    "peak_rss_bytes", (c.get("host_memory") or {}).get(
                        "rss_bytes"))
                for c in chunks]
    mem_device = [m for m in mem_device if m is not None]
    mem_host = [m for m in mem_host if m is not None]
    if mem_device or mem_host:
        summary["memory"] = {}
        if mem_device:
            summary["memory"]["device_peak_bytes"] = max(mem_device)
        if mem_host:
            summary["memory"]["host_peak_rss_bytes"] = max(mem_host)

    if hooks:
        by_hook: dict[str, float] = {}
        for h in hooks:
            by_hook[h.get("name", "?")] = (
                by_hook.get(h.get("name", "?"), 0.0) + (h.get("seconds") or 0.0)
            )
        summary["hook_s"] = {k: round(v, 4) for k, v in by_hook.items()}
        # instrumentation share: host-hook wall-clock as a fraction of the
        # run's train+hook time — the SLO overhead ceiling gates on it
        hook_total = sum(by_hook.values())
        if total_chunk_s > 0:
            summary["overhead"] = {
                "hook_s_total": round(hook_total, 4),
                "hook_frac": round(
                    hook_total / (total_chunk_s + hook_total), 6),
            }

    # Heartbeat coverage (docs/observability.md): the liveness signal's
    # max silent gap, measured over the lead process's beats INCLUDING the
    # edges (run_start -> first beat, last beat -> run_end) — a worker that
    # died silent mid-run shows the gap even though no beat recorded it.
    # Present only when the stream carries heartbeats (older streams gate
    # as "not comparable", never as a fake zero-gap).
    heartbeats = of_type("heartbeat", per_run)
    if heartbeats:
        stamps = [e.get("t", 0.0) for e in heartbeats]
        for edge in of_type("run_start", per_run) + run_ends:
            stamps.append(edge.get("t", 0.0))
        stamps.sort()
        max_gap = max(
            (b - a for a, b in zip(stamps, stamps[1:])), default=0.0)
        intervals = [e.get("interval_s") for e in heartbeats
                     if e.get("interval_s")]
        summary["heartbeats"] = {
            "count": len(heartbeats),
            "boundary_beats": sum(
                1 for e in heartbeats if e.get("phase") == "boundary"),
            "max_gap_s": round(max_gap, 3),
            "interval_s": intervals[-1] if intervals else None,
        }
        summary["heartbeat_max_gap_s"] = round(max_gap, 3)

    # SLO engine residue (telemetry/slo.py): durable alerts + info-plane
    # transitions, counted so `compare`/dashboards see them at a glance
    alerts = of_type("alert", events)
    if alerts:
        by_rule: dict[str, int] = {}
        for a in alerts:
            by_rule[a.get("rule", "?")] = by_rule.get(a.get("rule", "?"), 0) + 1
        summary["alerts"] = {"count": len(alerts), "by_rule": by_rule}
    transitions = of_type("transition", events)
    if transitions:
        summary["transitions"] = {
            "count": len(transitions),
            "channels": sorted({t.get("channel") for t in transitions
                                if t.get("channel") is not None}),
            "down": sum(1 for t in transitions
                        if t.get("direction") == "down"),
            "up": sum(1 for t in transitions if t.get("direction") == "up"),
        }

    metrics_events = of_type("metrics", per_run)
    if metrics_events:
        # last end-of-fit rollup, lead process's flat snapshot (chunk-time
        # percentiles, step counters — see telemetry/metrics.py)
        snaps = metrics_events[-1].get("snapshots") or []
        if snaps:
            summary["metrics"] = {
                k: v for k, v in snaps[0].items() if k != "proc"
            }
    return summary


# Gated fields: (summary key, bad direction). "down" = a drop beyond the
# threshold regresses (throughput, MI lower bound); "up" = a rise does
# (losses). Mitigations are gated separately — ANY increase regresses.
_GATES: Sequence[tuple[str, str]] = (
    ("steps_per_s", "down"),
    ("steady_steps_per_s", "down"),
    ("final_loss", "up"),
    ("final_val_loss", "up"),
    ("final_mi_lower_bits_mean", "down"),
    # silent-gap regression: the longest interval with no heartbeat grew —
    # a run that goes dark for longer than its baseline did is a liveness
    # regression even when throughput held (docs/observability.md)
    ("heartbeat_max_gap_s", "up"),
    # overlap regression: the overlapped measurement's exposed fraction
    # grew — MI bounds are serializing chunk boundaries again
    # (docs/performance.md "Overlapped measurement")
    ("overlap_exposed_frac", "up"),
)


def compare(
    summary_a: dict, summary_b: dict, threshold: float = 0.05
) -> tuple[dict, bool]:
    """Diff run B (candidate) against run A (baseline).

    Returns ``(report, regressed)``. A field regresses when its RELATIVE
    move in the bad direction exceeds ``threshold``. Per-replica LIST
    fields (sweep runs' final losses) gate on their MEAN — skipping them
    silently would leave the flagship sweep runs ungated on quality.
    Comparisons where either side is missing or unusable are reported
    with an explicit ``"gated": false``.
    """

    def scalarize(v):
        # "NaN"/"Infinity" string spellings (events.py's strict-JSON
        # encoding of a diverged run) parse back to real floats here
        if isinstance(v, str):
            try:
                v = float(v)
            except ValueError:
                return None
        if isinstance(v, bool) or v is None:
            return None
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, (list, tuple)):
            nums = [scalarize(x) for x in v]
            if v and all(x is not None for x in nums):
                return sum(nums) / len(nums)
            return None
        return None

    fields: dict[str, dict] = {}
    regressed = False
    for key, bad in _GATES:
        a_raw, b_raw = summary_a.get(key), summary_b.get(key)
        row: dict = {"a": a_raw, "b": b_raw, "bad_direction": bad}
        a, b = scalarize(a_raw), scalarize(b_raw)
        if isinstance(a_raw, (list, tuple)) or isinstance(b_raw, (list, tuple)):
            row["gated_on"] = "mean"
        if a is not None and math.isfinite(a) \
                and b is not None and math.isfinite(b):
            row["delta"] = round(b - a, 6)
            denom = max(abs(a), 1e-12)
            rel = (b - a) / denom
            row["rel"] = round(rel, 6)
            row["regressed"] = (
                rel < -threshold if bad == "down" else rel > threshold
            )
        elif (a is not None and math.isfinite(a)
              and b is not None and not math.isfinite(b)):
            # a finite baseline against a diverged candidate: that is THE
            # regression the gate exists for, not an ungateable comparison
            row["regressed"] = True
            row["reason"] = "candidate non-finite"
        else:
            row["gated"] = False
            row["regressed"] = False
        regressed = regressed or row["regressed"]
        fields[key] = row

    a_mit = summary_a.get("mitigations_total", 0) or 0
    b_mit = summary_b.get("mitigations_total", 0) or 0
    fields["mitigations_total"] = {
        "a": a_mit, "b": b_mit, "delta": b_mit - a_mit,
        "bad_direction": "up",
        # reliability, not noise: one extra kill/restart is a regression
        "regressed": b_mit > a_mit,
    }
    regressed = regressed or b_mit > a_mit

    # Per-phase latency gates (docs/observability.md "Request anatomy"):
    # a serving phase's p99 growing past threshold is gated like any
    # scalar, but with a small ABSOLUTE floor — µs-scale phases (parse on
    # a tiny body) jitter by whole multiples without meaning anything, so
    # only moves of at least 0.1 ms can regress. Gated dynamically over
    # the phases PRESENT IN BOTH summaries (a phase one side never
    # traversed is not comparable).
    a_phases = (summary_a.get("serving") or {}).get("phases") or {}
    b_phases = (summary_b.get("serving") or {}).get("phases") or {}
    for phase in sorted(set(a_phases) & set(b_phases)):
        a_p99 = scalarize((a_phases[phase] or {}).get("p99_ms"))
        b_p99 = scalarize((b_phases[phase] or {}).get("p99_ms"))
        row = {"a": a_p99, "b": b_p99, "bad_direction": "up"}
        if a_p99 is not None and math.isfinite(a_p99) \
                and b_p99 is not None and math.isfinite(b_p99):
            row["delta"] = round(b_p99 - a_p99, 6)
            rel = (b_p99 - a_p99) / max(abs(a_p99), 1e-12)
            row["rel"] = round(rel, 6)
            row["regressed"] = rel > threshold \
                and (b_p99 - a_p99) > 0.1
        else:
            row["gated"] = False
            row["regressed"] = False
        regressed = regressed or row["regressed"]
        fields[f"serving_phase_{phase}_p99_ms"] = row

    def undetected(summary):
        f = summary.get("faults") or {}
        return (f.get("injected", 0) or 0) - (f.get("detected", 0) or 0)

    a_und, b_und = undetected(summary_a), undetected(summary_b)
    # An injected fault nobody detected is a broken recovery path — a
    # regression in the candidate REGARDLESS of the baseline (a drilled
    # mitigation that stopped firing must never pass the gate).
    fields["faults_undetected"] = {
        "a": a_und, "b": b_und, "bad_direction": "up",
        "regressed": b_und > 0,
    }
    regressed = regressed or b_und > 0

    if (summary_a.get("config_hash") and summary_b.get("config_hash")
            and summary_a["config_hash"] != summary_b["config_hash"]):
        note = "config_hash differs: runs are not like-for-like"
    else:
        note = None
    report = {
        "threshold": threshold,
        "fields": fields,
        "regressed": regressed,
    }
    if note:
        report["note"] = note
    return report, regressed


def _load_side(path: str, process_index: int | None,
               run_id: str | None = None) -> dict:
    """A compare operand: an events.jsonl / run dir, a precomputed summary
    JSON (detected by its ``metric`` field), or a bench one-liner (its
    summary rides under a ``telemetry`` key — every bench line is a valid
    baseline)."""
    if os.path.isfile(path):
        try:
            with open(path) as f:
                record = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError):
            record = None  # multi-line jsonl: summarize below
        if isinstance(record, dict):
            if record.get("metric") == "run_telemetry_summary":
                return record
            embedded = record.get("telemetry")
            if (isinstance(embedded, dict)
                    and embedded.get("metric") == "run_telemetry_summary"):
                return embedded
    return summarize(path, process_index=process_index, run_id=run_id)


#: The ``telemetry`` actions the port does not have yet, each refused with
#: one line before any work: the live dashboard, the SLO check and the fleet
#: aggregator (``live.py``'s ``tail``, ``slo.py``, ``fleet.py``).
NOT_PORTED_ACTIONS = ("tail", "check", "fleet")
SLO_AND_FLEET = "ROADMAP.md queue 1, item 6 (slo.py, fleet.py and the tail dashboard)"


def telemetry_main(argv: Sequence[str]) -> int:
    """``python -m dib_tpu_torch telemetry summarize|compare|report|runs``,
    with the flags and exit codes of the JAX package's ``telemetry``: 0 on
    success, 1 when ``compare`` finds a regression, 2 on a bad operand."""
    argv = list(argv)
    if argv and argv[0] in NOT_PORTED_ACTIONS:
        print(f"dib_tpu_torch telemetry: {argv[0]!r} is not ported ({SLO_AND_FLEET})",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(
        prog="dib_tpu_torch telemetry",
        description="Summarize or diff run event streams.",
    )
    sub = parser.add_subparsers(dest="action", required=True)
    p_sum = sub.add_parser("summarize", help="Roll an events.jsonl into one record.")
    p_sum.add_argument("path", help="Run dir or events.jsonl path.")
    p_sum.add_argument("--process-index", type=int, default=None)
    p_sum.add_argument("--run-id", default=None,
                       help="Restrict to one run's events when several invocations "
                            "appended to the same stream.")
    p_sum.add_argument("--indent", action="store_true")
    p_cmp = sub.add_parser("compare", help="Diff run B against baseline A.")
    p_cmp.add_argument("baseline", help="Run dir / events.jsonl / summary JSON.")
    p_cmp.add_argument("candidate", help="Run dir / events.jsonl / summary JSON.")
    p_cmp.add_argument("--threshold", type=float, default=0.05,
                       help="Relative regression threshold (default 0.05).")
    p_cmp.add_argument("--process-index", type=int, default=None)
    p_cmp.add_argument("--run-id-a", default=None,
                       help="Restrict the baseline to one run's events.")
    p_cmp.add_argument("--run-id-b", default=None,
                       help="Restrict the candidate to one run's events.")
    p_cmp.add_argument("--indent", action="store_true")
    p_rep = sub.add_parser(
        "report",
        help="Render a self-contained static HTML run report (span breakdown, "
             "training trajectory, MI bounds, memory) — or, with --index, the "
             "multi-run index page with the perf trajectory.")
    p_rep.add_argument("path", nargs="?", default=None,
                       help="Run dir or events.jsonl path (omit with --index).")
    p_rep.add_argument("--out", default=None,
                       help="Output HTML path (default: report.html next to the events "
                            "file; index.html under the runs root with --index).")
    p_rep.add_argument("--process-index", type=int, default=None)
    p_rep.add_argument("--run-id", default=None, help="Restrict to one run's events.")
    p_rep.add_argument("--index", action="store_true",
                       help="Render the index page from the run registry instead of one "
                            "run's report.")
    p_rep.add_argument("--runs-root", "--runs_root", dest="runs_root", default=None,
                       help="Runs root for --index (default: DIB_RUNS_ROOT or ./runs).")
    p_runs = sub.add_parser(
        "runs", help="Query the run registry (append-only <runs-root>/index.jsonl).")
    runs_sub = p_runs.add_subparsers(dest="runs_action", required=True)
    p_list = runs_sub.add_parser("list", help="Latest entry per run.")
    p_show = runs_sub.add_parser("show", help="One run's full entry.")
    p_show.add_argument("run_id")
    p_show.add_argument("--full-history", action="store_true",
                        help="Every index line for the run, not just the latest.")
    p_traj = runs_sub.add_parser("trajectory", help="The bench perf trajectory, oldest first.")
    for p in (p_list, p_show, p_traj):
        p.add_argument("--runs-root", "--runs_root", dest="runs_root", default=None,
                       help="Runs root (default: DIB_RUNS_ROOT or ./runs).")
    for action in NOT_PORTED_ACTIONS:
        sub.add_parser(action, help=f"Not ported: refused ({SLO_AND_FLEET}).")
    args = parser.parse_args(argv)

    try:
        if args.action == "summarize":
            record = summarize(args.path, process_index=args.process_index,
                               run_id=args.run_id)
            print(json.dumps(record, indent=1 if args.indent else None))
            return 0
        if args.action == "report":
            from dib_tpu_torch.telemetry.report import write_index, write_report

            if args.index:
                from dib_tpu_torch.telemetry.registry import resolve_runs_root

                root = resolve_runs_root(args.runs_root)
                if not root:
                    print("telemetry report --index: no runs root", file=sys.stderr)
                    return 2
                print(write_index(root, out=args.out))
                return 0
            if not args.path:
                print("telemetry report: a run dir/events path is required "
                      "(or pass --index)", file=sys.stderr)
                return 2
            print(write_report(args.path, out=args.out, process_index=args.process_index,
                               run_id=args.run_id))
            return 0
        if args.action == "runs":
            from dib_tpu_torch.telemetry.registry import runs_main

            return runs_main(args)
        a = _load_side(args.baseline, args.process_index, run_id=args.run_id_a)
        b = _load_side(args.candidate, args.process_index, run_id=args.run_id_b)
    except (ValueError, OSError) as exc:
        # a bad operand (not a stream, no events, unreadable) is distinct
        # from a regression verdict, which is exit code 1
        print(f"telemetry {args.action}: {exc}", file=sys.stderr)
        return 2
    report, regressed = compare(a, b, threshold=args.threshold)
    print(json.dumps(report, indent=1 if args.indent else None))
    if regressed:
        print(f"telemetry compare: REGRESSION beyond threshold {args.threshold}",
              file=sys.stderr)
    return 1 if regressed else 0
