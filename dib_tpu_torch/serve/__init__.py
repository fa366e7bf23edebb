"""Inference serving for DIB models (counterpart of ``dib_tpu/serve``).

  - :mod:`dib_tpu_torch.serve.engine` — bucketed deterministic inference
    (posterior-mean predict / per-feature encode / per-channel KL).
  - :mod:`dib_tpu_torch.serve.batcher` — bounded continuous micro-batching
    queue with timeouts, backpressure and per-request error isolation.
  - :mod:`dib_tpu_torch.serve.replicas` — round-robin dispatch across CUDA
    devices and across β-sweep members ("the model at β≈x"), with
    per-replica health: consecutive-failure ejection, probe re-admission,
    batcher-worker revival.
  - :mod:`dib_tpu_torch.serve.pool` — replicas in worker SUBPROCESSES
    behind a pipe request plane; worker death degrades to the surviving
    replicas and probes respawn.
  - :mod:`dib_tpu_torch.serve.zoo` — many checkpoints behind one endpoint:
    named model registry and a keyed response cache with reload
    invalidation.
  - :mod:`dib_tpu_torch.serve.server` — asyncio event-loop JSON HTTP API
    (``/v1/predict``, ``/v1/encode``, ``/v1/models``, ``/healthz``,
    ``/metrics``) with admission control and per-tenant token-bucket
    quotas (429), behind ``python -m dib_tpu_torch serve``.
  - :mod:`dib_tpu_torch.serve.prefork` — N server processes on one
    ``SO_REUSEPORT`` port; :mod:`dib_tpu_torch.serve.top` — the fleet
    dashboard over ``/metrics``.

The names below load their module on first access (PEP 562), so
``serve top`` and the prefork supervisor start without importing torch.
"""

_EXPORTS = {
    "DEFAULT_BUCKETS": "engine",
    "InferenceEngine": "engine",
    "BatcherClosed": "batcher",
    "MicroBatcher": "batcher",
    "QueueFullError": "batcher",
    "RequestTimeout": "batcher",
    "WorkerDiedError": "pool",
    "WorkerReplica": "pool",
    "pool_router": "pool",
    "NoHealthyReplicaError": "replicas",
    "ReplicaEntry": "replicas",
    "ReplicaRouter": "replicas",
    "DIBServer": "server",
    "TenantQuotas": "server",
    "ModelZoo": "zoo",
    "ResponseCache": "zoo",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(f"dib_tpu_torch.serve.{_EXPORTS[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'dib_tpu_torch.serve' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
