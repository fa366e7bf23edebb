"""Host-side telemetry of the port (counterpart of ``dib_tpu/telemetry``).

The metrics registry (:mod:`~dib_tpu_torch.telemetry.metrics`), the run's
event stream (:mod:`~dib_tpu_torch.telemetry.events`, with the JAX
package's schema), the trace context (:mod:`~dib_tpu_torch.telemetry.
context`), spans that also mark NVTX ranges (:mod:`~dib_tpu_torch.
telemetry.trace`), the fit's recorder and heartbeats (:mod:`~dib_tpu_torch.
telemetry.hooks`) and the stream follower the watchdog reads
(:mod:`~dib_tpu_torch.telemetry.live`); the stream's readers: run
summaries and the regression gate (:mod:`~dib_tpu_torch.telemetry.summary`),
static HTML reports (:mod:`~dib_tpu_torch.telemetry.report`) and the run
registry (:mod:`~dib_tpu_torch.telemetry.registry`). The SLO engine, the
fleet aggregator and the live dashboard wait for ROADMAP.md queue 1, item 6.
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
from dib_tpu_torch.telemetry.registry import RunRegistry, register_run
from dib_tpu_torch.telemetry.summary import compare, summarize, telemetry_main
from dib_tpu_torch.telemetry.trace import Tracer

__all__ = [
    "BUCKET_BOUNDS",
    "Counter",
    "EVENT_SCHEMA",
    "EventWriter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REQUEST_PHASES",
    "RunRegistry",
    "Tracer",
    "bucket_counts",
    "bucket_index",
    "bucket_quantile",
    "compare",
    "finalize_crashed",
    "finalize_open_writers",
    "gather_snapshots",
    "open_writer",
    "prometheus_text",
    "read_events",
    "register_run",
    "runtime_manifest",
    "shared_run_id",
    "summarize",
    "telemetry_main",
    "validate_event",
    "write_metrics",
]
