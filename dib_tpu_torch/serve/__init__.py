"""Inference serving for DIB models.

  - :mod:`dib_tpu_torch.serve.engine` — bucketed deterministic inference
    (posterior-mean predict / per-feature encode / per-channel KL).
  - :mod:`dib_tpu_torch.serve.batcher` — bounded continuous micro-batching
    queue with timeouts, backpressure and per-request error isolation.
"""

from dib_tpu_torch.serve.batcher import (
    BatcherClosed,
    MicroBatcher,
    QueueFullError,
    RequestTimeout,
)
from dib_tpu_torch.serve.engine import DEFAULT_BUCKETS, InferenceEngine

__all__ = [
    "DEFAULT_BUCKETS",
    "BatcherClosed",
    "InferenceEngine",
    "MicroBatcher",
    "QueueFullError",
    "RequestTimeout",
]
