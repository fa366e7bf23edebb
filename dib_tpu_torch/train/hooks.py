"""Instrumentation hooks (counterpart of ``dib_tpu/train/hooks.py``).

``all_features_bounds`` is the paper's per-feature information query on a
fixed set of weights; ``InfoPerFeatureHook`` runs it between training
chunks and keeps the trajectory (or, with ``overlap=True``, on a side CUDA
stream while the next chunk trains), ``CompressionMatrixHook`` renders
each channel's compression scheme, and ``Every`` gives a hook its own
cadence.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dib_tpu_torch.ops.density import MAX_DIM
from dib_tpu_torch.ops.gaussian import reparameterize
from dib_tpu_torch.ops.info_bounds import mi_sandwich_from_params
from dib_tpu_torch.ops.schedules import log_annealed_beta


def all_features_bounds(model, rows, batch_size: int = 1024, num_batches: int = 8,
                        generator: torch.Generator | None = None,
                        idx: torch.Tensor | None = None, u: torch.Tensor | None = None):
    """Per-feature MI sandwich bounds of every channel at once.

    Draws ``num_batches`` evaluation batches of ``batch_size`` rows with
    replacement from ``rows`` ([n, width]), encodes each, and bounds all F
    channels of a batch in ONE kernel launch over the leading feature axis.
    Returns ([F] lower, [F] upper) in nats, averaged over the batches.

    ``idx`` ([num_batches, batch_size] row indices) and ``u``
    ([num_batches, F, batch_size, d] samples) replace the draws from
    ``generator`` (which must live on the model's device), so a test can
    replay another implementation's draws.
    """
    device = next(model.parameters()).device
    rows = torch.as_tensor(rows, dtype=torch.float32, device=device)
    lowers, uppers = [], []
    with torch.inference_mode():
        for b in range(num_batches):
            batch_idx = idx[b].to(device) if idx is not None else torch.randint(
                0, rows.shape[0], (batch_size,), generator=generator, device=device)
            mus, logvars = model.encode(rows[batch_idx])                 # [F, B, d]
            u_b = u[b].to(device) if u is not None else reparameterize(mus, logvars, generator)
            lower, upper = mi_sandwich_from_params(mus, logvars, u=u_b)  # [F] each
            lowers.append(lower)
            uppers.append(upper)
    return torch.stack(lowers).mean(0), torch.stack(uppers).mean(0)


def check_channel_width(d: int, device) -> None:
    """Refuse channels wider than the GPU's MI kernel takes, on the GPU:
    called before training, so a run does not die at its first hook."""
    if torch.device(device).type == "cuda" and d > MAX_DIM:
        raise ValueError(
            f"the MI bounds run mi_row_stats, whose CUDA kernel takes channels of at most "
            f"{MAX_DIM} dimensions (MAX_DIM); these channels have {d}. Use an embedding "
            f"dimension of at most {MAX_DIM} (ROADMAP.md queue 2 gives the kernel wider "
            "channels).")


class Every:
    """Run ``hook`` only when the epoch is a multiple of ``cadence``, so hooks
    with different cadences share one ``fit(hook_every=...)`` chunking (pass
    the gcd as ``hook_every``)."""

    def __init__(self, cadence: int, hook):
        self.cadence = max(int(cadence), 1)
        self.hook = hook

    def fires_at(self, epoch: int) -> bool:
        return epoch % self.cadence == 0

    def check(self, trainer):
        if hasattr(self.hook, "check"):
            self.hook.check(trainer)

    def __call__(self, trainer, state, epoch: int):
        if self.fires_at(epoch):
            self.hook(trainer, state, epoch)


class InfoPerFeatureHook:
    """Accumulates (epoch, per-feature (lower, upper)) MI bounds in nats on
    the validation rows, every channel of an eval batch in one kernel launch
    (:func:`all_features_bounds`).

    Draws come from a generator seeded with ``seed`` on the model's device,
    running across calls as the JAX hook's key does; ``draws`` (a callable
    ``(model, rows) -> (idx, u)``, called once per invocation) replaces
    them, so a test can replay another implementation's draws.

    ``overlap=True`` measures a snapshot of the model on a side CUDA stream
    and files the result at the next call, or at the first read of
    ``records`` (``train/overlap.py``): the measurement runs while the next
    chunk trains, and its numbers are those of ``overlap=False``.
    ``telemetry`` (an ``EventWriter``) gets one ``mi_bounds`` event per
    record. ``rewind(epoch)`` (called by ``fit`` after a rollback) drops the
    records past ``epoch`` and returns the generator to where it stood, so
    the replay draws what the uninterrupted run drew.
    """

    def __init__(self, evaluation_batch_size: int = 1024, number_evaluation_batches: int = 8,
                 seed: int = 0, draws=None, overlap: bool = False, telemetry=None):
        self.evaluation_batch_size = evaluation_batch_size
        self.number_evaluation_batches = number_evaluation_batches
        self.seed = seed
        self.draws = draws
        self.overlap = overlap
        self.telemetry = telemetry
        self._records: list[dict] = []
        self._generator_states: list = []    # the generator's state before each record's call
        self._pending = None
        self._runner = None
        self._generator = None
        self._rows = None
        self._rows_for = None     # the bundle the uploaded rows came from

    @property
    def records(self) -> list[dict]:
        """The measurements (an overlapped one in flight is collected first)."""
        self._flush_pending()
        return self._records

    @records.setter
    def records(self, value) -> None:
        self._pending = None
        self._records = value
        self._generator_states = [None] * len(value)

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        from dib_tpu_torch.train.overlap import collect_overlapped

        pending, self._pending = self._pending, None
        lower, upper = collect_overlapped(pending)
        self._file_record(pending.meta["epoch"], lower, upper)

    def _file_record(self, epoch: int, lower, upper) -> None:
        bounds = [(float(a), float(b)) for a, b in zip(lower.tolist(), upper.tolist())]
        self._records.append({"epoch": epoch, "bounds": bounds})
        if self.telemetry is not None:
            bits = np.asarray(bounds) / np.log(2.0)
            self.telemetry.mi_bounds(epoch=epoch, lower_bits=bits[:, 0].tolist(),
                                     upper_bits=bits[:, 1].tolist())

    def rewind(self, epoch: int) -> None:
        """Forget the records past ``epoch`` and return the generator to
        its state before the first of them."""
        records = self.records
        keep = sum(1 for r in records if r["epoch"] <= epoch)
        if keep < len(records):
            state = self._generator_states[keep]
            if state is not None and self._generator is not None:
                self._generator.set_state(state)
            del records[keep:]
            del self._generator_states[keep:]

    def check(self, trainer):
        """Called by ``fit`` before its first epoch: refuses channels the
        GPU's kernel does not take."""
        check_channel_width(trainer.model.noise_shape(1)[-1], trainer.device)

    def __call__(self, trainer, state, epoch: int):
        model = trainer.model
        device = next(model.parameters()).device
        if self._rows_for is not trainer.bundle or self._rows.device != device:
            self._rows = torch.as_tensor(trainer.bundle.x_valid, dtype=torch.float32,
                                         device=device)
            self._rows_for = trainer.bundle
        self._flush_pending()
        idx = u = None
        if self.draws is not None:
            idx, u = self.draws(model, self._rows)
        elif self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device).manual_seed(self.seed)
        self._generator_states.append(None if self._generator is None or self.draws is not None
                                      else self._generator.get_state())
        if not self.overlap:
            lower, upper = all_features_bounds(
                model, self._rows, self.evaluation_batch_size, self.number_evaluation_batches,
                generator=self._generator, idx=idx, u=u)
            self._file_record(epoch, lower, upper)
            return
        from dib_tpu_torch.train.overlap import OverlapRunner

        if self._runner is None:
            self._runner = OverlapRunner()
        shadow = self._runner.snapshot(model)
        self._pending = self._runner.launch(
            lambda: all_features_bounds(shadow, self._rows, self.evaluation_batch_size,
                                        self.number_evaluation_batches,
                                        generator=self._generator, idx=idx, u=u),
            device, epoch=epoch, reads=[self._rows])

    @property
    def bounds_bits(self) -> np.ndarray:
        """[T, F, 2] array of (lower, upper) in bits."""
        return np.asarray([r["bounds"] for r in self.records]) / np.log(2.0)

    @property
    def epochs(self) -> np.ndarray:
        return np.asarray([r["epoch"] for r in self.records])


class CompressionMatrixHook:
    """Saves each channel's compression-scheme matrix at each invocation, as
    ``{outdir}/feature_{f}_log10beta_{log10 beta:.3f}.png``, beta from the
    trainer's schedule at that epoch.

    One ``default_rng(seed)`` picks the displayed rows and advances once per
    (call, feature) in call order, as the JAX hook's does. ``features=None``
    draws every channel; for an encoder shared by every slot (the
    per-particle model) pass ``(0,)``, the other slots' schemes being the
    same. Renders with matplotlib (imported at the first call).
    """

    def __init__(self, outdir: str, max_number_to_display: int = 128, seed: int = 0,
                 features=None):
        self.outdir = outdir
        self.max_number_to_display = max_number_to_display
        self.rng = np.random.default_rng(seed)
        self.features = features
        os.makedirs(outdir, exist_ok=True)

    def __call__(self, trainer, state, epoch: int):
        from dib_tpu_torch.viz.compression import save_compression_matrix

        cfg = trainer.config
        beta = float(log_annealed_beta(epoch, cfg.beta_start, cfg.beta_end,
                                       cfg.num_annealing_epochs, cfg.num_pretraining_epochs))
        raw_all = trainer.bundle.x_valid_raw
        feature_ids = range(trainer.num_features) if self.features is None else self.features
        for f in feature_ids:
            x_f = trainer.feature_data(f)
            raw_f = trainer.feature_data(f, arr=raw_all) if raw_all is not None else x_f
            mus, logvars = trainer.encode_feature(state, f, x_f)
            fname = os.path.join(self.outdir, f"feature_{f}_log10beta_{np.log10(beta):.3f}.png")
            save_compression_matrix(mus.cpu().numpy(), logvars.cpu().numpy(), raw_f, fname,
                                    feature_label=trainer.bundle.feature_labels[f],
                                    max_number_to_display=self.max_number_to_display,
                                    rng=self.rng)
