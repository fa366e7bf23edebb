"""Host-side telemetry of the port (counterpart of ``dib_tpu/telemetry``).

The metrics registry (:mod:`~dib_tpu_torch.telemetry.metrics`), the run's
event stream (:mod:`~dib_tpu_torch.telemetry.events`, with the JAX
package's schema), the trace context (:mod:`~dib_tpu_torch.telemetry.
context`), spans that also mark NVTX ranges (:mod:`~dib_tpu_torch.
telemetry.trace`), the fit's recorder and heartbeats (:mod:`~dib_tpu_torch.
telemetry.hooks`) and the stream follower the watchdog reads
(:mod:`~dib_tpu_torch.telemetry.live`). The run registry, summaries,
reports and the live dashboard wait for ROADMAP.md queue 1, item 6.
"""

from dib_tpu_torch.telemetry.events import (
    EVENT_SCHEMA,
    REQUEST_PHASES,
    EventWriter,
    finalize_crashed,
    finalize_open_writers,
    open_writer,
    read_events,
    runtime_manifest,
    shared_run_id,
    validate_event,
)
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
    write_metrics,
)

__all__ = [
    "BUCKET_BOUNDS",
    "Counter",
    "EVENT_SCHEMA",
    "EventWriter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REQUEST_PHASES",
    "bucket_counts",
    "bucket_index",
    "bucket_quantile",
    "finalize_crashed",
    "finalize_open_writers",
    "gather_snapshots",
    "open_writer",
    "prometheus_text",
    "read_events",
    "runtime_manifest",
    "shared_run_id",
    "validate_event",
    "write_metrics",
]
