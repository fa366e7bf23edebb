"""Deterministic bucketed inference over a DIB model
(counterpart of ``dib_tpu/serve/engine.py``).

  - **Posterior-mean inference** (``sample=False``): serving never draws
    noise, so the same input always yields the same output and padded
    micro-batching is semantically invisible (every op of the forward pass is
    row-independent).
  - **Fixed batch buckets**: a request batch is padded to the nearest bucket,
    and rows beyond the top bucket run in top-bucket chunks. The forward pass
    runs eagerly; the JAX package's per-bucket AOT executables have no
    counterpart yet. Where the JAX engine compiles every (op, bucket) at
    construction, this one runs each once, so the device's lazy start
    (CUDA's context, cuBLAS handles, kernel selection per shape) is paid
    there and not by the first requests.
  - **Per-channel KL as a served quantity**: ``predict`` returns each
    example's per-feature KL (nats) beside the prediction.
  - **Dispatch metrics**: with a ``registry`` each dispatch counts in
    ``serve.dispatches.<op>`` and times in ``serve.dispatch_s.<op>``. The
    interval ends after the host copy of the outputs, which synchronises
    the device, so it is the dispatch's own time. The JAX package's
    achieved-FLOP/s and bandwidth gauges come from XLA's cost analysis,
    which has no counterpart here; they are left out.

TF32 is switched off for matmuls and convolutions: the reference is full
float32. The engine carries no queueing policy; that lives in
:mod:`dib_tpu_torch.serve.batcher`.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from dib_tpu_torch import interop
from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.ops.gaussian import kl_diagonal_gaussian

__all__ = ["DEFAULT_BUCKETS", "InferenceEngine"]

DEFAULT_BUCKETS = (1, 8, 32, 128)


class InferenceEngine:
    """Deterministic bucketed inference for one model.

    Args:
      model: a ``DistributedIBModel``; it is moved to ``device`` and put in
        eval mode.
      batch_buckets: padded batch sizes, ascending. Requests larger than the
        top bucket are dispatched in top-bucket chunks.
      device: where the model runs; ``None`` means the GPU.
      registry: optional ``MetricsRegistry`` for the per-op dispatch count
        and time.
      beta_end: optional β label (a sweep member's annealing endpoint).
    """

    def __init__(self, model, batch_buckets: Sequence[int] = DEFAULT_BUCKETS, device=None,
                 registry=None, beta_end: float | None = None):
        buckets = sorted(set(int(b) for b in batch_buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"batch_buckets must be positive, got {batch_buckets}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(buckets)
        self.registry = registry
        self.beta_end = beta_end
        self.feature_width = int(sum(model.feature_dimensionalities))
        self.num_features = len(model.feature_dimensionalities)
        self._warm_up()

    @classmethod
    def from_params(cls, model, flax_params, **kwargs) -> "InferenceEngine":
        """Engine over ``model`` loaded with a JAX package's Flax variables
        (a tree of numpy arrays, see :mod:`dib_tpu_torch.interop`)."""
        model.load_state_dict(interop.params_from_flax(flax_params))
        return cls(model, **kwargs)

    @classmethod
    def from_state(cls, architecture: dict, state_dict: dict, **kwargs) -> "InferenceEngine":
        """Engine over a ``DistributedIBModel`` rebuilt from its constructor
        arguments (``model.architecture``) and a state dict (tensors or numpy
        arrays): the recipe a pool worker process builds its engine from.
        ``kwargs`` go to the engine; the model is built on its ``device``."""
        from dib_tpu_torch.models import DistributedIBModel

        device = resolve_device(kwargs.get("device"))
        model = DistributedIBModel(**architecture, device=device,
                                   generator=torch.Generator())   # overwritten below
        model.load_state_dict({name: torch.as_tensor(value)
                               for name, value in state_dict.items()})
        return cls(model, **kwargs)

    @classmethod
    def from_checkpoint(cls, trainer, directory: str, replica: int | None = None,
                        **kwargs) -> "InferenceEngine":
        """Engine over the newest step of a ``DIBCheckpointer`` directory.

        ``trainer`` gives the restore template (a ``DIBTrainer``, or a
        ``BetaSweepTrainer`` with ``replica`` naming the member to serve);
        its model receives the checkpoint's weights. The step's manifest is
        verified inside ``restore``: an architecture mismatch fails naming
        the differing leaves, a corrupt step raises
        ``CheckpointCorruptionError``. ``kwargs`` go to the engine
        (``batch_buckets``, ``device``; the trainer's device by default).
        """
        from dib_tpu_torch.train.checkpoint import DIBCheckpointer

        state, _, _ = DIBCheckpointer(directory).restore(trainer)
        model = state.params["model"]
        if replica is not None:
            model = model.carve(replica)
        kwargs.setdefault("device", trainer.device)
        return cls(model, **kwargs)

    # ------------------------------------------------------------- forward fns
    def _predict_fn(self, x: torch.Tensor) -> dict:
        prediction, aux = self.model(x, sample=False)
        # [F, B] per-example channel KL -> [B, F] for per-request splitting
        kl = kl_diagonal_gaussian(aux["mus"], aux["logvars"])
        return {"prediction": prediction, "kl_per_feature": kl.transpose(0, 1)}

    def _encode_fn(self, x: torch.Tensor) -> dict:
        mus, logvars = self.model.encode(x)                  # [F, B, d] each
        return {"mus": mus.transpose(0, 1), "logvars": logvars.transpose(0, 1)}

    def _warm_up(self) -> None:
        """One forward pass per (op, bucket) on zeros, outside the metrics."""
        with torch.inference_mode():
            for bucket in self.buckets:
                x = torch.zeros((bucket, self.feature_width), device=self.device)
                self._predict_fn(x)
                self._encode_fn(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` rows (top bucket if none)."""
        for bucket in self.buckets:
            if bucket >= n:
                return bucket
        return self.buckets[-1]

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    # -------------------------------------------------------------- dispatch
    def _dispatch(self, op: str, x: np.ndarray) -> dict:
        """Pad ``x`` to its bucket, run the forward pass, slice back."""
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if x.shape[1] != self.feature_width:
            raise ValueError(
                f"expected rows of width {self.feature_width} "
                f"(sum of feature dims), got {x.shape[1]}"
            )
        if n > self.max_bucket:
            parts = [
                self._dispatch(op, x[i : i + self.max_bucket])
                for i in range(0, n, self.max_bucket)
            ]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        bucket = self.bucket_for(n)
        x_pad = np.zeros((bucket, self.feature_width), np.float32)
        x_pad[:n] = x
        fn = self._predict_fn if op == "predict" else self._encode_fn
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = fn(torch.from_numpy(x_pad).to(self.device))
            # the host copy synchronises the device: the interval is the dispatch
            out = {k: v[:n].cpu().numpy() for k, v in out.items()}
            self._observe(op, time.perf_counter() - t0)
            return out

    def _observe(self, op: str, seconds: float) -> None:
        if self.registry is None:
            return
        self.registry.counter(f"serve.dispatches.{op}").inc()
        self.registry.histogram(f"serve.dispatch_s.{op}").record(seconds)

    # ----------------------------------------------------------- public API
    def predict(self, x) -> dict:
        """Posterior-mean prediction + per-example per-channel KL (nats).

        ``x``: [B, sum(feature_dims)] (or a single [sum(feature_dims)] row).
        Returns ``{"prediction": [B, out], "kl_per_feature": [B, F]}``.
        """
        return self._dispatch("predict", _as_rows(x))

    def encode(self, x) -> dict:
        """Per-feature Gaussian channel parameters:
        ``{"mus": [B, F, d], "logvars": [B, F, d]}``."""
        return self._dispatch("encode", _as_rows(x))


def _as_rows(x) -> np.ndarray:
    """Coerce a request payload to a float32 [B, width] row matrix."""
    arr = np.asarray(x, np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"expected 1-D or 2-D input, got shape {arr.shape}")
    return arr
