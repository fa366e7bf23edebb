"""Sweep-native instrumentation: every replica measured at once
(counterpart of ``dib_tpu/parallel/sweep_hooks.py``).

``SweepInfoPerFeatureHook`` bounds the MI of every channel of every replica
of a sweep: per evaluation batch, one stacked encode gives [R, P, B, d]
channel parameters, and all R x P channels go to ``mi_row_stats`` as the
groups of one launch (split only past the kernel's group limit). Records
keep the JAX hook's shapes and units ([R, F, 2] nats), so per-replica
plotting is unchanged. ``SweepCompressionHook`` pulls every replica's
compression scheme with one stacked encode per (call, feature) and saves it
as ``.npz``; ``render()`` draws the PNGs the serial
``CompressionMatrixHook`` would have drawn, after the timed run. The MI
hook's ``overlap=True`` measures on a side CUDA stream while the next chunk
trains (``train/overlap.py``), and ``telemetry=`` writes one ``mi_bounds``
event per record.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from dib_tpu_torch.ops.density import MAX_GROUPS
from dib_tpu_torch.ops.gaussian import reparameterize
from dib_tpu_torch.ops.info_bounds import mi_sandwich_from_params
from dib_tpu_torch.ops.schedules import log_annealed_beta
from dib_tpu_torch.train.hooks import check_channel_width


def call_seed(seed: int, call: int) -> int:
    """The seed of a hook's ``call``-th measurement (0-based)."""
    return int(np.random.SeedSequence([seed, call]).generate_state(1)[0])


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
    (``.epochs``, ``.bounds_bits``).

    The n-th call (0-based, counting the records kept) draws from a
    generator on the model's device seeded with ``call_seed(seed, n)``, as
    the JAX hook derives the n-th call's key from its seed: the draws depend
    on the call's index, not on the calls made before it in this process,
    so a resumed run that measures an epoch again draws what the
    uninterrupted run drew. ``draws`` (a callable ``(model, rows, n) ->
    (idx, u)`` of :func:`sweep_features_bounds`' shapes) replaces them.

    ``persist``: a directory each record is mirrored to, as
    ``epoch{E}.npz``. Its records are read back only when the caller says
    the run resumes (``resume=True``); a call then drops the read records
    at or past its epoch, which the resumed run measures again.

    ``overlap=True`` measures a snapshot of the stacked model on a side
    CUDA stream and files the result at the next call, or at the first
    read of ``records`` (``train/overlap.py``), with the numbers of
    ``overlap=False``. ``telemetry`` (an ``EventWriter``) gets one
    ``mi_bounds`` event per record: each replica's mean bounds in bits,
    with its beta endpoint. ``rewind(epoch)`` drops the records past
    ``epoch`` (``fit`` calls it after a rollback).
    """

    def __init__(self, evaluation_batch_size: int = 1024, number_evaluation_batches: int = 8,
                 seed: int = 0, persist: str | None = None, resume: bool = False, draws=None,
                 overlap: bool = False, telemetry=None):
        self.evaluation_batch_size = evaluation_batch_size
        self.number_evaluation_batches = number_evaluation_batches
        self.seed = seed
        self.draws = draws
        self.persist = persist
        self.overlap = overlap
        self.telemetry = telemetry
        self._records: list[dict] = []
        self._pending = None
        self._runner = None
        self._beta_ends = None
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
                    self._records.append({"epoch": int(data["epoch"]),
                                          "bounds": np.asarray(data["bounds"])})

    @property
    def records(self) -> list[dict]:
        """The measurements (an overlapped one in flight is collected first)."""
        self._flush_pending()
        return self._records

    @records.setter
    def records(self, value) -> None:
        self._pending = None
        self._records = value

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        from dib_tpu_torch.train.overlap import collect_overlapped

        pending, self._pending = self._pending, None
        lower, upper = collect_overlapped(pending)
        self._file_record(pending.meta["epoch"], torch.stack([lower, upper], dim=-1).numpy())

    def _file_record(self, epoch: int, bounds: np.ndarray) -> None:
        """Append one [R, F, 2]-nats record, its event and its mirror."""
        self._records.append({"epoch": epoch, "bounds": bounds})
        if self.telemetry is not None:
            ln2 = np.log(2.0)
            self.telemetry.mi_bounds(epoch=epoch,
                                     lower_bits=(bounds[..., 0].mean(-1) / ln2).tolist(),
                                     upper_bits=(bounds[..., 1].mean(-1) / ln2).tolist(),
                                     beta_end=self._beta_ends)
        if self.persist:
            path = os.path.join(self.persist, f"epoch{epoch}.npz")
            np.savez(f"{path}.tmp.npz", epoch=epoch, bounds=bounds)
            os.replace(f"{path}.tmp.npz", path)

    def rewind(self, epoch: int) -> None:
        """Forget the records past ``epoch``; the next call's index, and
        with it its draws, follow."""
        self.records = [r for r in self.records if r["epoch"] <= epoch]

    def check(self, sweep):
        """Called by ``fit`` before its first epoch: refuses channels the
        GPU's kernel does not take."""
        check_channel_width(sweep.model.noise_shape(1)[-1], sweep.device)

    def __call__(self, sweep, states, epoch: int):
        model = sweep.model
        device = next(model.parameters()).device
        if self._rows_for is not sweep.bundle or self._rows.device != device:
            self._rows = torch.as_tensor(sweep.bundle.x_valid, dtype=torch.float32,
                                         device=device)
            self._rows_for = sweep.bundle
        self._beta_ends = [float(b) for b in sweep.beta_ends_host]
        self.records = [r for r in self.records if r["epoch"] < epoch]
        call = len(self._records)
        idx = u = generator = None
        if self.draws is not None:
            idx, u = self.draws(model, self._rows, call)
        else:
            generator = torch.Generator(device=device).manual_seed(call_seed(self.seed, call))
        if not self.overlap:
            lower, upper = sweep_features_bounds(
                model, self._rows, self.evaluation_batch_size, self.number_evaluation_batches,
                generator=generator, idx=idx, u=u)
            self._file_record(epoch, torch.stack([lower, upper], dim=-1).cpu().numpy())
            return
        from dib_tpu_torch.train.overlap import OverlapRunner

        if self._runner is None:
            self._runner = OverlapRunner()
        shadow = self._runner.snapshot(model)
        self._pending = self._runner.launch(
            lambda: sweep_features_bounds(shadow, self._rows, self.evaluation_batch_size,
                                          self.number_evaluation_batches, generator=generator,
                                          idx=idx, u=u),
            device, epoch=epoch, reads=[self._rows])

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


class SweepCompressionHook:
    """Compression schemes of every replica, rendering deferred off the clock.

    Each call encodes the validation rows of each feature in ``features``
    once through the stacked model ([R, N, d] channel parameters) and writes
    ``{outdir}/schemes/scheme_epoch{E}_feature{F}.npz`` holding ``mus``,
    ``logvars``, the replicas' ``betas`` at that epoch, ``epoch`` and
    ``feature``; ``saved`` lists them in call order. A call at or before the
    last saved epoch (a resumed run measuring again) drops the later
    entries, whose files it overwrites; a call from another sweep starts a
    new record. ``resume=True`` rebuilds ``saved`` from the files on disk,
    epochs ascending and features in this hook's order, the order the calls
    that wrote them ran in.

    ``render(bundle)`` draws every saved scheme into
    ``{outdir}/replica{r}/compression/feature_{f}_log10beta_{beta:.3f}.png``,
    replicas outside and records inside, each replica with its own
    ``default_rng(seed)``: the rows the serial ``CompressionMatrixHook(seed=
    seed)`` of that replica would display.
    """

    def __init__(self, outdir: str, features=(0,), max_number_to_display: int = 128,
                 seed: int = 0, resume: bool = False):
        self.outdir = outdir
        self.features = tuple(features)
        self.max_number_to_display = max_number_to_display
        self.seed = seed
        self.saved: list[dict] = []
        self._feature_rows = {}
        self._cache_for = None     # the sweep whose rows are uploaded and whose record this is
        schemes = os.path.join(outdir, "schemes")
        os.makedirs(schemes, exist_ok=True)
        if resume:
            found = {}
            for name in os.listdir(schemes):
                match = re.fullmatch(r"scheme_epoch(\d+)_feature(\d+)\.npz", name)
                if match:
                    found[(int(match.group(1)), int(match.group(2)))] = name
            for epoch in sorted({e for e, _ in found}):
                for f in self.features:
                    if (epoch, f) in found:
                        self.saved.append({"path": os.path.join(schemes, found[(epoch, f)]),
                                           "epoch": epoch, "feature": f})

    def __call__(self, sweep, states, epoch: int):
        model = states.params["model"]
        if getattr(model, "replicas", None) is None:
            raise ValueError(
                f"SweepCompressionHook needs a model with a replica axis; got "
                f"{type(model).__name__} without one (DistributedIBModel's replica axis is "
                "not ported yet); use CompressionMatrixHook on a serial trainer")
        if sweep is not self._cache_for:
            self._feature_rows.clear()
            if self._cache_for is not None:       # a new run: keep render() to one sweep
                self.saved.clear()
            self._cache_for = sweep
        self.saved = [s for s in self.saved if s["epoch"] < epoch]
        cfg = sweep.config
        betas = np.array([
            float(log_annealed_beta(epoch, float(start), float(end), cfg.num_annealing_epochs,
                                    cfg.num_pretraining_epochs))
            for start, end in zip(sweep.beta_starts_host, sweep.beta_ends_host)])
        for f in self.features:
            if f not in self._feature_rows:
                self._feature_rows[f] = torch.as_tensor(sweep.feature_data(f),
                                                        dtype=torch.float32, device=sweep.device)
            mus, logvars = sweep.encode_feature(states, f, self._feature_rows[f])
            path = os.path.join(self.outdir, "schemes", f"scheme_epoch{epoch}_feature{f}.npz")
            np.savez(path, mus=mus.cpu().numpy(), logvars=logvars.cpu().numpy(), betas=betas,
                     epoch=epoch, feature=f)
            self.saved.append({"path": path, "epoch": epoch, "feature": f})

    def render(self, bundle) -> list[str]:
        """Draw every saved scheme; returns the PNG paths."""
        from dib_tpu_torch.viz.compression import save_compression_matrix

        dims = list(bundle.feature_dimensionalities)
        raw_all = bundle.x_valid_raw if bundle.x_valid_raw is not None else bundle.x_valid
        paths = []
        replicas = 0
        if self.saved:
            with np.load(self.saved[0]["path"]) as data:
                replicas = int(data["mus"].shape[0])
        for r in range(replicas):
            rng = np.random.default_rng(self.seed)
            outdir = os.path.join(self.outdir, f"replica{r}", "compression")
            os.makedirs(outdir, exist_ok=True)
            for record in self.saved:
                with np.load(record["path"]) as data:
                    f = int(data["feature"])
                    mus, logvars, beta = data["mus"][r], data["logvars"][r], data["betas"][r]
                start = int(np.sum(dims[:f]))
                fname = os.path.join(outdir, f"feature_{f}_log10beta_{np.log10(beta):.3f}.png")
                save_compression_matrix(
                    mus, logvars, raw_all[:, start:start + dims[f]], fname,
                    feature_label=bundle.feature_labels[f] if bundle.feature_labels else None,
                    max_number_to_display=self.max_number_to_display, rng=rng)
                paths.append(fname)
        return paths
