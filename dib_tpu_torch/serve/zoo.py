"""Model zoo: many checkpoints behind one endpoint, with a response cache
(counterpart of ``dib_tpu/serve/zoo.py``).

  - :class:`ModelZoo`: named models, each backed by its own
    ``ReplicaRouter`` (device replicas, β replicas or pool workers);
    requests select with ``{"model": name}`` and the zoo resolves a default
    for single-model deployments.
  - :class:`ResponseCache`: a keyed LRU over full responses for repeated
    ``(input, β, checkpoint)`` queries. Serving is deterministic
    (posterior mean, no sampling), so for an unchanged checkpoint the cached
    response IS the response. Reloading a checkpoint invalidates every
    cached response of that model.

The cache publishes hit/miss/invalidation counters to the
``MetricsRegistry`` (``/metrics``).

The JAX package's ``ExecutableLRU`` (a capacity-bounded cache of AOT
executables) is left out: the port's engine runs eagerly and holds no
per-bucket executable. Its counterpart, a per-bucket CUDA graph, waits for
the port's benchmark (ROADMAP.md), and ``--exec_cache`` is refused.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["ModelZoo", "ResponseCache", "response_key"]


def response_key(model: str, op: str, beta: float | None,
                 rows: np.ndarray) -> tuple:
    """Cache key for one request: the checkpoint identity, the op, the β
    routing target, and a digest of the exact input bytes."""
    digest = hashlib.sha1(
        rows.tobytes() + repr(rows.shape).encode()).hexdigest()
    return (model, op, None if beta is None else float(beta), digest)


class ResponseCache:
    """Bounded LRU over full responses for repeated deterministic queries.

    Values are the result dicts the engine returned (numpy arrays); a hit
    skips queueing, batching, and dispatch entirely. Keys carry the model
    name, so :meth:`invalidate` can drop exactly one checkpoint's entries
    when it reloads.
    """

    def __init__(self, capacity: int, registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.registry = registry
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.counter(f"serve.cache.response.{name}").inc()

    def get(self, key: tuple) -> dict | None:
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
        self._count("hits" if value is not None else "misses")
        return value

    def put(self, key: tuple, value: dict) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def invalidate(self, model: str) -> int:
        """Drop every cached response for ``model`` (checkpoint reload:
        yesterday's params must never answer today's queries)."""
        with self._lock:
            stale = [k for k in self._entries if k[0] == model]
            for k in stale:
                del self._entries[k]
        if stale:
            self._count("invalidations")
        return len(stale)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "capacity": self.capacity}


class _ZooModel:
    """One registered model: its router + provenance."""

    __slots__ = ("name", "router", "checkpoint_dir", "reloads", "routing")

    def __init__(self, name: str, router, checkpoint_dir: str | None):
        self.name = name
        self.router = router
        self.checkpoint_dir = checkpoint_dir
        self.reloads = 0
        # advisory β-routing metadata (the autopilot's refreshed
        # transition-β map); survives reloads — the estimates describe
        # the DATA, not one checkpoint's params
        self.routing: dict | None = None


class ModelZoo:
    """Named checkpoints behind one serving endpoint.

    ``response_capacity`` > 0 arms the :class:`ResponseCache` the server
    consults before admission. The first registered model is the default a
    body without ``"model"`` resolves to. ``telemetry`` receives a
    ``mitigation`` event (``zoo_reloaded``) per reload.
    """

    def __init__(self, response_capacity: int | None = None,
                 telemetry=None, registry=None):
        self.telemetry = telemetry
        self.registry = registry
        self.response_cache = (
            ResponseCache(response_capacity, registry=registry)
            if response_capacity else None)
        self._models: "OrderedDict[str, _ZooModel]" = OrderedDict()
        self._lock = threading.Lock()

    # ---------------------------------------------------------- registry
    def register(self, name: str, router,
                 checkpoint_dir: str | None = None) -> None:
        """Add (or error on a duplicate of) one named model."""
        if not name:
            raise ValueError("model name must be non-empty")
        with self._lock:
            if name in self._models:
                raise ValueError(
                    f"model {name!r} already registered (use reload())")
            self._models[name] = _ZooModel(name, router, checkpoint_dir)

    def reload(self, name: str, router,
               checkpoint_dir: str | None = None) -> None:
        """Swap a model's router for a freshly-restored one, invalidating
        its cached responses (computed against the old params). The old
        router is closed after the swap, so in-flight requests drain
        against the old params and new requests see only the new ones."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(f"model {name!r} is not registered "
                               f"(have: {list(self._models)})")
            old_router = entry.router
            entry.router = router
            if checkpoint_dir is not None:
                entry.checkpoint_dir = checkpoint_dir
            entry.reloads += 1
        if self.response_cache is not None:
            self.response_cache.invalidate(name)
        if self.registry is not None:
            self.registry.counter("serve.zoo.reloads").inc()
        if self.telemetry is not None:
            self.telemetry.mitigation(mtype="zoo_reloaded", model=name)
        old_router.close()

    # ---------------------------------------------------------- builders
    def add_params(self, name: str, model, params: dict | None = None,
                   checkpoint_dir: str | None = None, **router_kwargs):
        """Register device replicas of ``model`` (loaded with the state dict
        ``params`` when given), see ``ReplicaRouter.from_params``."""
        from dib_tpu_torch.serve.replicas import ReplicaRouter

        router = ReplicaRouter.from_params(model, params, **router_kwargs)
        self.register(name, router, checkpoint_dir=checkpoint_dir)
        return router

    def add_sweep(self, name: str, sweep, states,
                  checkpoint_dir: str | None = None, **router_kwargs):
        """Register a β-sweep's members as ONE zoo model with β-labeled
        replicas (``ReplicaRouter.from_sweep``)."""
        from dib_tpu_torch.serve.replicas import ReplicaRouter

        router = ReplicaRouter.from_sweep(sweep, states, **router_kwargs)
        self.register(name, router, checkpoint_dir=checkpoint_dir)
        return router

    def add_sweep_checkpoint(self, name: str, checkpoint_dir: str, sweep,
                             **router_kwargs):
        """Register a port sweep CHECKPOINT directly: the newest step of
        ``checkpoint_dir`` is restored into ``sweep`` (a ``BetaSweepTrainer``
        whose model and endpoints match the run that wrote it; the
        manifest's structure check names any mismatch), and every member
        serves as a β-labeled replica behind one model name. The JAX
        package's mesh consolidation (a checkpoint trained on a mesh) waits
        for ROADMAP.md queue 1, item 7."""
        from dib_tpu_torch.train.checkpoint import DIBCheckpointer

        states, _, _ = DIBCheckpointer(checkpoint_dir).restore(sweep)
        return self.add_sweep(name, sweep, states,
                              checkpoint_dir=checkpoint_dir, **router_kwargs)

    # ----------------------------------------------------------- resolve
    def resolve(self, name: str | None = None):
        """(name, router) for a request's model selector; None resolves
        the default (first-registered) model."""
        with self._lock:
            if not self._models:
                raise KeyError("zoo is empty: no models registered")
            if name is None:
                name = next(iter(self._models))
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(
                    f"unknown model {name!r} (have: {list(self._models)})")
            return entry.name, entry.router

    def names(self) -> list[str]:
        with self._lock:
            return list(self._models)

    def set_routing(self, name: str, metadata: dict | None) -> None:
        """Attach (or clear, with None) advisory β-routing metadata —
        the autopilot's refreshed transition-β map — to one model. Shown
        on ``/v1/models`` via :meth:`describe`; never a serving gate, so
        no cache is invalidated and no router is touched."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(f"model {name!r} is not registered "
                               f"(have: {list(self._models)})")
            entry.routing = None if metadata is None else dict(metadata)

    def describe(self) -> list[dict]:
        """The ``/v1/models`` surface."""
        with self._lock:
            entries = list(self._models.values())
        out = []
        for entry in entries:
            row = {
                "model": entry.name,
                "replicas": len(entry.router.entries),
                "reloads": entry.reloads,
                "beta_ends": [e.beta_end for e in entry.router.entries
                              if e.beta_end is not None] or None,
            }
            if entry.checkpoint_dir:
                row["checkpoint_dir"] = entry.checkpoint_dir
            if entry.routing is not None:
                row["routing"] = entry.routing
            out.append({k: v for k, v in row.items() if v is not None})
        return out

    def routers(self) -> list:
        with self._lock:
            return [entry.router for entry in self._models.values()]

    def cache_stats(self) -> dict:
        out = {}
        if self.response_cache is not None:
            out["response"] = self.response_cache.stats()
        return out

    def close(self) -> None:
        for router in self.routers():
            router.close()

    # ------------------------------------------------------ construction
    @classmethod
    def single(cls, router, name: str = "default",
               response_capacity: int | None = None,
               telemetry=None, registry=None) -> "ModelZoo":
        """Wrap one pre-built router as a single-model zoo — the shim the
        server uses so every deployment routes through the same code."""
        zoo = cls(response_capacity=response_capacity,
                  telemetry=telemetry, registry=registry)
        zoo.register(name, router)
        return zoo
