"""Sweep-native instrumentation: every replica measured at once
(counterpart of ``dib_tpu/parallel/sweep_hooks.py::SweepInfoPerFeatureHook``).

``SweepInfoPerFeatureHook`` bounds the MI of every channel of every replica
of a sweep: per evaluation batch, one stacked encode gives [R, P, B, d]
channel parameters, and all R x P channels go to ``mi_row_stats`` as the
groups of one launch (split only past the kernel's group limit). Records
keep the JAX hook's shapes and units ([R, F, 2] nats), so per-replica
plotting is unchanged. Not ported yet: ``overlap=`` and ``telemetry=``, and
``SweepCompressionHook`` (with ``CompressionMatrixHook``).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from dib_tpu_torch.ops.density import MAX_GROUPS
from dib_tpu_torch.ops.gaussian import reparameterize
from dib_tpu_torch.ops.info_bounds import mi_sandwich_from_params


def sweep_features_bounds(model, rows: torch.Tensor, batch_size: int, num_batches: int,
                          generator: torch.Generator | None = None,
                          idx: torch.Tensor | None = None, u: torch.Tensor | None = None):
    """[R, F] (lower, upper) MI bounds in nats of every channel of a model
    with replicas, averaged over ``num_batches`` evaluation batches.

    Each replica draws its own ``batch_size`` row indices with replacement
    from ``rows`` ([n, width] on the model's device). ``idx`` ([batches, R,
    B]) and ``u`` ([batches, R, F, B, d]) replace the draws from
    ``generator``, so a test can replay another implementation's.
    """
    replicas = model.replicas
    lowers, uppers = [], []
    with torch.inference_mode():
        for b in range(num_batches):
            batch_idx = idx[b].to(rows.device) if idx is not None else torch.randint(
                0, rows.shape[0], (replicas, batch_size), generator=generator,
                device=rows.device)
            mus, logvars = model.encode(rows[batch_idx])               # [R, F, B, d]
            u_b = u[b].to(rows.device) if u is not None else reparameterize(mus, logvars,
                                                                            generator)
            groups = [t.reshape(-1, *t.shape[2:]) for t in (mus, logvars, u_b)]   # [R*F, B, d]
            bounds = [mi_sandwich_from_params(m, lv, u=uu) for m, lv, uu in zip(
                *(g.split(MAX_GROUPS) for g in groups))]
            lowers.append(torch.cat([lo for lo, _ in bounds]).reshape(mus.shape[:2]))
            uppers.append(torch.cat([up for _, up in bounds]).reshape(mus.shape[:2]))
    return torch.stack(lowers).mean(0), torch.stack(uppers).mean(0)


class SweepInfoPerFeatureHook:
    """[R, F] MI sandwich bounds per call, every channel of every replica.

    Called as a sweep hook ``hook(sweep, states, epoch)``; accumulates
    ``records`` of ``{"epoch": int, "bounds": [R, F, 2] nats}`` from the
    validation rows. ``replica_view(r)`` gives a serial-hook-shaped view
    (``.epochs``, ``.bounds_bits``). Draws come from a generator seeded with
    ``seed`` on the model's device; ``draws`` (a callable ``(model, rows)
    -> (idx, u)`` of :func:`sweep_features_bounds`' shapes, called once per
    call) replaces them.

    ``persist``: a directory each record is mirrored to, as
    ``epoch{E}.npz``. Its records are read back only when the caller says
    the run resumes (``resume=True``); a call then drops the read records
    at or past its epoch, which the resumed run measures again.
    """

    def __init__(self, evaluation_batch_size: int = 1024, number_evaluation_batches: int = 8,
                 seed: int = 0, persist: str | None = None, resume: bool = False, draws=None):
        self.evaluation_batch_size = evaluation_batch_size
        self.number_evaluation_batches = number_evaluation_batches
        self.seed = seed
        self.draws = draws
        self.persist = persist
        self.records: list[dict] = []
        self._generator = None
        self._rows = None
        self._rows_for = None     # the bundle the uploaded rows came from
        if persist:
            os.makedirs(persist, exist_ok=True)
        if persist and resume:
            found = []
            for name in os.listdir(persist):
                match = re.fullmatch(r"epoch(\d+)\.npz", name)
                if match:
                    found.append((int(match.group(1)), name))
            for _, name in sorted(found):
                with np.load(os.path.join(persist, name)) as data:
                    self.records.append({"epoch": int(data["epoch"]),
                                         "bounds": np.asarray(data["bounds"])})

    def __call__(self, sweep, states, epoch: int):
        model = sweep.model
        device = next(model.parameters()).device
        if self._rows_for is not sweep.bundle or self._rows.device != device:
            self._rows = torch.as_tensor(sweep.bundle.x_valid, dtype=torch.float32,
                                         device=device)
            self._rows_for = sweep.bundle
        self.records = [r for r in self.records if r["epoch"] < epoch]
        idx = u = None
        if self.draws is not None:
            idx, u = self.draws(model, self._rows)
        elif self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device).manual_seed(self.seed)
        lower, upper = sweep_features_bounds(
            model, self._rows, self.evaluation_batch_size, self.number_evaluation_batches,
            generator=self._generator, idx=idx, u=u)
        bounds = torch.stack([lower, upper], dim=-1).cpu().numpy()     # [R, F, 2] nats
        self.records.append({"epoch": epoch, "bounds": bounds})
        if self.persist:
            path = os.path.join(self.persist, f"epoch{epoch}.npz")
            np.savez(f"{path}.tmp.npz", epoch=epoch, bounds=bounds)
            os.replace(f"{path}.tmp.npz", path)

    @property
    def epochs(self) -> np.ndarray:
        return np.asarray([r["epoch"] for r in self.records])

    def bounds_bits(self, r: int) -> np.ndarray:
        """[T, F, 2] (lower, upper) in bits for replica ``r``."""
        return np.asarray([rec["bounds"][r] for rec in self.records]) / np.log(2.0)

    def replica_view(self, r: int):
        """Replica ``r``'s records in the serial hook's shape: ``.epochs``
        and ``.bounds_bits`` ([T, F, 2] bits)."""
        return _ReplicaView(self.epochs, self.bounds_bits(r))


class _ReplicaView:
    def __init__(self, epochs: np.ndarray, bounds_bits: np.ndarray):
        self.epochs = epochs
        self.bounds_bits = bounds_bits
