"""Lightweight counters / gauges / histograms (counterpart of
``dib_tpu/telemetry/metrics.py``).

Host-side metric plumbing for serving and run telemetry, NOT a time-series
database: everything is in-process and cheap (a dict update per
observation). The serving ``/metrics`` route and the CLI's closing summary
line read a :class:`MetricsRegistry`; :func:`prometheus_text` renders it in
the Prometheus exposition format, and the fixed fleet-wide histogram buckets
let N prefork workers' snapshots merge by addition (``serve top``).

Multi-process contract: every process keeps its own registry with the SAME
metric names; :func:`gather_snapshots` collects one flat snapshot per
process (over ``torch.distributed`` when a process group is up), and
:func:`write_metrics` writes them as one ``metrics`` event on a run's
event stream (``telemetry/events.py``).
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from collections import deque

__all__ = [
    "BUCKET_BOUNDS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "bucket_counts",
    "bucket_index",
    "bucket_quantile",
    "gather_snapshots",
    "prometheus_text",
]

# Fleet-wide histogram bucket bounds, in seconds: log-spaced, 8 buckets per
# decade from 1 µs to 100 s. FIXED across every process and every release —
# N prefork workers' ``/metrics`` merge by plain per-bucket addition only
# because every worker buckets identically. Changing these bounds is a
# telemetry schema change (old and new workers would stop being mergeable).
BUCKET_BOUNDS = tuple(10.0 ** (-6.0 + i / 8.0) for i in range(65))

# Observations above the last bound land in the overflow bucket at this
# index (``le_inf`` in snapshots, ``le="+Inf"`` in Prometheus text).
_OVERFLOW = len(BUCKET_BOUNDS)


def bucket_index(value: float) -> int:
    """Dense bucket index for ``value``: smallest i with
    ``value <= BUCKET_BOUNDS[i]``, or the overflow index past the end.
    Pure function of the fixed bounds — every worker agrees."""
    return bisect_left(BUCKET_BOUNDS, float(value))


def bucket_counts(hist_snapshot: dict) -> list:
    """Dense per-bucket counts (len ``len(BUCKET_BOUNDS)+1``) from a
    histogram snapshot's sparse ``le_NNN``/``le_inf`` keys.

    Snapshots store only nonzero buckets; this re-densifies them so
    merged fleets can be summed index-wise and fed to
    :func:`bucket_quantile`. Tolerates snapshots whose numeric values
    were floated in flight (``_flatten``, JSON round-trips)."""
    dense = [0] * (_OVERFLOW + 1)
    for key, value in hist_snapshot.items():
        if not key.startswith("le_"):
            continue
        tail = key[3:]
        idx = _OVERFLOW if tail == "inf" else int(tail)
        dense[idx] += int(round(float(value)))
    return dense

def bucket_quantile(counts, q: float):
    """Nearest-rank quantile estimate from dense per-bucket counts:
    the upper bound of the bucket holding the rank-``ceil(q*total)``
    observation (overflow reports the last finite bound).

    Deterministic pure function of the counts — merging two workers'
    buckets by addition then calling this gives bit-identical results
    to bucketing the combined stream, which is the whole point of
    fixed fleet-wide bounds. Returns None when the histogram is empty."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = max(1, math.ceil(q * total))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return BUCKET_BOUNDS[min(i, _OVERFLOW - 1)]
    return BUCKET_BOUNDS[-1]


class Counter:
    """Monotonically increasing count (events, steps, mitigations).

    Updates are locked: the serving path (``dib_tpu_torch/serve``) increments
    from many batcher/HTTP threads at once, and an unlocked ``+=`` is a
    read-modify-write that drops counts under contention. The training
    path is single-threaded; an uncontended lock costs ~100 ns.
    """

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"Counter increments must be >= 0, got {amount}")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-write-wins instantaneous value (memory bytes, current beta)."""

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)   # single store: atomic under the GIL


class Histogram:
    """Streaming distribution summary over a bounded window.

    Tracks exact count/sum/min/max over the full stream, percentiles
    over the trailing ``window`` observations, and exact per-bucket
    counts over the full stream against the fixed fleet-wide
    :data:`BUCKET_BOUNDS` — the windowed percentiles answer "what is
    this worker doing right now", the buckets make N workers'
    snapshots mergeable by addition. ``record``/``snapshot`` are
    locked (see Counter).
    """

    def __init__(self, window: int = 4096):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._buckets = [0] * (_OVERFLOW + 1)
        self._window = deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self._buckets[bucket_index(value)] += 1
            self._window.append(value)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.min is not None else 0.0,
                "max": self.max if self.max is not None else 0.0,
                "mean": self.sum / self.count if self.count else 0.0,
            }
            # Sparse flat keys, not a nested dict: snapshot leaves must
            # stay one level deep so _flatten / fleet merging see
            # "histograms.<name>.le_NNN" and sum them like any stat.
            for i, c in enumerate(self._buckets):
                if c:
                    key = "le_inf" if i == _OVERFLOW else f"le_{i:03d}"
                    out[key] = c
            window = list(self._window)
        if window:
            ordered = sorted(window)
            for name, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
                out[name] = ordered[min(int(q * len(ordered)), len(ordered) - 1)]
        return out


class MetricsRegistry:
    """Named metric store: ``registry.counter("steps").inc(50)``."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._histograms.setdefault(name, Histogram(window))

    def snapshot(self) -> dict:
        """Nested JSON-ready view of every metric's current value."""
        # list(): serving threads may register a metric mid-snapshot
        return {
            "counters": {k: c.value for k, c in list(self._counters.items())},
            "gauges": {k: g.value for k, g in list(self._gauges.items())},
            "histograms": {
                k: h.snapshot() for k, h in list(self._histograms.items())
            },
        }


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    """Prometheus metric name: dotted registry names become underscored,
    everything outside [a-zA-Z0-9_:] sanitized, ``prefix_`` prepended."""
    return f"{prefix}_{_PROM_BAD.sub('_', name)}"


def prometheus_text(snapshot: dict, prefix: str = "dib") -> str:
    """Render a :meth:`MetricsRegistry.snapshot` in Prometheus text
    exposition format (version 0.0.4 — what every Prometheus scraper and
    most collectors speak).

    Counters map to ``counter``, gauges to ``gauge``; histograms map to
    TWO families. The legacy ``summary`` (``_count``/``_sum`` plus
    ``quantile``-labelled samples from the windowed p50/p90/p99) with
    ``_min``/``_max`` gauges is kept for back-compat — per-worker
    quantiles are honest but mathematically impossible to aggregate
    across a prefork fleet. The native ``{name}_hist`` ``histogram``
    family renders the fixed fleet-wide :data:`BUCKET_BOUNDS` as
    cumulative ``_bucket{le=...}`` samples (the ``+Inf`` bucket is
    ALWAYS emitted, so ``histogram_quantile()`` works even on an empty
    or bucket-less snapshot) with matching ``_hist_sum``/``_hist_count``
    — those merge across workers by plain addition. The serving
    ``/metrics`` endpoint returns this under content negotiation."""
    lines: list[str] = []

    def sample(name: str, value, labels: str = "") -> None:
        v = float(value)
        if v != v:   # NaN never reaches a scraper
            return
        # shortest round-trip repr, never '%g': a 7-digit request counter
        # must not be exposed as 1.23457e+06 (rate()/increase() over
        # scrapes would drift from truth)
        text = str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)
        lines.append(f"{name}{labels} {text}")

    for name, value in sorted((snapshot.get("counters") or {}).items()):
        prom = _prom_name(name, prefix)
        lines.append(f"# TYPE {prom} counter")
        sample(prom, value)
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        prom = _prom_name(name, prefix)
        lines.append(f"# TYPE {prom} gauge")
        sample(prom, value)
    for name, hist in sorted((snapshot.get("histograms") or {}).items()):
        prom = _prom_name(name, prefix)
        lines.append(f"# TYPE {prom} summary")
        for label, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            if key in hist:
                sample(prom, hist[key], labels='{quantile="%s"}' % label)
        sample(f"{prom}_sum", hist.get("sum", 0.0))
        sample(f"{prom}_count", hist.get("count", 0))
        for edge in ("min", "max"):
            lines.append(f"# TYPE {prom}_{edge} gauge")
            sample(f"{prom}_{edge}", hist.get(edge) or 0.0)
        # Native histogram family: cumulative buckets against the fixed
        # fleet-wide bounds. Only populated buckets get a finite-le line
        # (keeps the exposition compact; a missing le series scrapes as
        # zero), but +Inf is unconditional and _hist_count == _hist_sum's
        # companion always equals the +Inf bucket — the consistency
        # histogram_quantile() and rate() arithmetic rely on.
        dense = bucket_counts(hist)
        lines.append(f"# TYPE {prom}_hist histogram")
        cumulative = 0
        for i, c in enumerate(dense[:_OVERFLOW]):
            cumulative += c
            if c:
                le = f"{BUCKET_BOUNDS[i]:.6g}"
                sample(f"{prom}_hist_bucket", cumulative,
                       labels='{le="%s"}' % le)
        sample(f"{prom}_hist_bucket", hist.get("count", 0),
               labels='{le="+Inf"}')
        sample(f"{prom}_hist_sum", hist.get("sum", 0.0))
        sample(f"{prom}_hist_count", hist.get("count", 0))
    return "\n".join(lines) + "\n"


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = float(value)
    return out


def gather_snapshots(registry: MetricsRegistry) -> list[dict]:
    """Per-process flat snapshots, one dict per process, ``proc`` tagged.

    Single process (or no ``torch.distributed`` process group): just the
    local snapshot. Otherwise every rank's flattened values travel through
    ``all_gather_object`` (names are identical across processes by the
    contract above); every rank receives all snapshots.
    """
    local = _flatten(registry.snapshot())
    try:
        import torch.distributed as dist
    except ImportError:      # a torch without distributed support
        dist = None
    if dist is None or not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return [{"proc": 0, **local}]
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    return [{"proc": p, **snap} for p, snap in enumerate(gathered)]


def write_metrics(registry: MetricsRegistry, writer) -> bool:
    """Snapshot ``registry`` into a ``metrics`` event on ``writer``.

    Returns True iff this process wrote (rank 0, or no process group);
    other ranks contribute through the gather and return False.
    """
    snapshots = gather_snapshots(registry)
    try:
        import torch.distributed as dist
    except ImportError:
        dist = None
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_rank() != 0:
        return False
    writer.metrics(snapshots)
    return True
