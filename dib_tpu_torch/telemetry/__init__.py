"""Host-side telemetry of the port (counterpart of ``dib_tpu/telemetry``).

Only the metrics registry is ported (:mod:`dib_tpu_torch.telemetry.metrics`)
and the closed vocabulary of request phases the HTTP server stamps. The
event stream, the tracer and the run registry wait for ROADMAP.md queue 1,
item 3.
"""

from dib_tpu_torch.telemetry.metrics import (
    BUCKET_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_counts,
    bucket_index,
    bucket_quantile,
    gather_snapshots,
    prometheus_text,
)

#: Closed vocabulary for a request's phases, in wire order (a copy of
#: ``dib_tpu/telemetry/events.py::REQUEST_PHASES``). Every phase the HTTP
#: server stamps comes from this tuple, and the per-phase histograms are
#: named ``serve.phase.<name>``. A request carries only the phases it
#: traversed (cached hits skip queue and batch; quota and shed rejections
#: skip queue, batch and dispatch).
REQUEST_PHASES = ("read", "parse", "admission", "queue", "batch",
                  "dispatch", "serialize", "write")

__all__ = [
    "BUCKET_BOUNDS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REQUEST_PHASES",
    "bucket_counts",
    "bucket_index",
    "bucket_quantile",
    "gather_snapshots",
    "prometheus_text",
]
