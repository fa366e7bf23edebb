"""Distributed-IB training (counterpart of ``dib_tpu/train/loop.py``).

The JAX trainer scans epochs and steps inside one jitted program; here a
plain Python loop over steps drives eager PyTorch, with beta computed from
the epoch index by the schedule (never stored in the model) and the history
written into preallocated device tensors, so the loop never waits on the
device between chunks of epochs. Hooks run between chunks, as
``hook(trainer, state, epoch)``.

Random draws (batch indices and the encoders' noise) come from a draws
object, by default :class:`GeneratorDraws` over one ``torch.Generator`` on
the trainer's device. A test replays the JAX key schedule by passing its
own object with the same three methods.

The loss core also trains a model with replicas (the beta sweep,
``dib_tpu_torch.parallel.sweep``): then every batch, noise, beta, loss and
history row has a leading replica axis, the task loss and metric are
reduced per replica, and one backward pass takes the sum over replicas.

``fit`` publishes what ``CheckpointHook`` saves (the generators that
draw, the live history and the chunk size) and takes a
``PreemptionGuard``; a resumed run passes the restored generator states.
It also writes the run's event stream (``telemetry=``), fires fault plans
(``fault_plan=``) and guards against divergence: after every chunk the
boundary row is fetched once and checked for non-finite values and
anomalies (``train/anomaly.py``); a bad boundary rolls the fit back to the
newest intact checkpoint of its checkpoint hook and replays from there,
bit for bit for a transient fault.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import warnings

import numpy as np
import torch
from torch import nn

from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.ops.schedules import log_annealed_beta
from dib_tpu_torch.ops.similarity import symmetric_infonce
from dib_tpu_torch.train.history import HistoryRecord, history_init, history_record
from dib_tpu_torch.train.losses import accuracy_for, resolve_loss

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig`` minus the prefetch knob (the
    permutation prefetch is not ported)."""

    learning_rate: float = 3e-4
    batch_size: int = 128
    beta_start: float = 1e-4
    beta_end: float = 3.0
    num_pretraining_epochs: int = 1000
    num_annealing_epochs: int = 10000
    steps_per_epoch: int = 0            # 0 -> ceil(num_train / batch_size)
    warmup_steps: int = 0               # linear LR warmup from 0
    optimizer: str = "adam"
    max_val_points: int = 4096          # fixed validation subset per epoch
    infonce_similarity: str = "l2"
    infonce_temperature: float = 1.0
    # 'replacement': independent uniform draws per step; 'permutation': one
    # shuffled pass (tiled when an epoch needs more rows than the data) per epoch
    batch_sampling: str = "replacement"

    @property
    def num_epochs(self) -> int:
        return self.num_pretraining_epochs + self.num_annealing_epochs


@dataclass
class TrainState:
    """What training carries between epochs: the trained modules (updated in
    place), the optimizer with its moments, its LR schedule, and the number
    of epochs done."""

    params: nn.ModuleDict
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LambdaLR
    epoch: int


def make_optimizer(config: TrainConfig, parameters):
    """``optax.adam`` or ``optax.sgd`` (plain, no momentum) with an optional
    linear warmup from 0, as (optimizer, per-update LR schedule). Like
    ``optax.linear_schedule(0, lr, warmup_steps)``, the first update uses a
    learning rate of 0."""
    if config.optimizer == "adam":
        optimizer = torch.optim.Adam(parameters, lr=config.learning_rate, betas=ADAM_BETAS,
                                     eps=ADAM_EPS)
    elif config.optimizer == "sgd":
        optimizer = torch.optim.SGD(parameters, lr=config.learning_rate)
    else:
        raise ValueError(f"Unknown optimizer {config.optimizer!r}")
    warmup = config.warmup_steps
    factor = (lambda update: min(update / warmup, 1.0)) if warmup > 0 else (lambda update: 1.0)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


class GeneratorDraws:
    """The trainer's random draws from one ``torch.Generator`` on its device.

    The trainer calls, for each epoch in order: ``start_epoch`` once, then
    ``step_noise`` for each step, then ``val_noise`` for each validation
    chunk.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @property
    def generators(self) -> list[torch.Generator]:
        """What a checkpoint saves to continue these draws."""
        return [self.generator]

    def start_epoch(self, n: int, steps: int, batch_size: int, sampling: str) -> torch.Tensor:
        """[steps, batch_size] row indices into the training data."""
        device = self.generator.device
        if sampling == "replacement":
            return torch.randint(0, n, (steps, batch_size), generator=self.generator,
                                 device=device)
        total = steps * batch_size
        perms = [torch.randperm(n, generator=self.generator, device=device)
                 for _ in range(-(-total // n))]
        return torch.cat(perms)[:total].reshape(steps, batch_size)

    def step_noise(self, step: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.generator.device)

    def val_noise(self, chunk: int, num_chunks: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.generator.device)

    def restore(self, generator_state, epoch: int) -> None:
        """Continue from a checkpoint's generator state (a rollback): the
        draws of epoch ``epoch`` on are the uninterrupted run's."""
        self.generator.set_state(torch.as_tensor(generator_state, dtype=torch.uint8).cpu())


class DIBTrainer:
    """Trains a ``DistributedIBModel`` or ``PerParticleDIBModel``
    (supervised, or contrastive against ``y_encoder``) on a bundle.

    Supervised: loss = task(prediction, y) + beta * sum_f KL_f. InfoNCE
    (``bundle.loss == 'infonce'``): the prediction is an embedding matched
    against ``y_encoder(y)`` by symmetric InfoNCE. The trainer runs on
    ``device`` (``None`` means the GPU) and moves the model there.
    """

    def __init__(self, model: nn.Module, bundle, config: TrainConfig,
                 y_encoder: nn.Module | None = None, *, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.bundle = bundle
        self.config = config
        self.y_encoder = None if y_encoder is None else y_encoder.to(self.device)
        self.replicas = getattr(model, "replicas", None)
        self.contrastive = bundle.loss == "infonce"
        if self.contrastive and y_encoder is None:
            raise ValueError("infonce loss requires a y_encoder model")
        if self.contrastive and self.replicas is not None:
            raise ValueError("contrastive training of a model with replicas is not ported")
        if config.batch_sampling not in ("replacement", "permutation"):
            raise ValueError(f"Unknown batch_sampling {config.batch_sampling!r} "
                             "(expected 'replacement' or 'permutation')")
        n = bundle.x_train.shape[0]
        self.steps_per_epoch = config.steps_per_epoch or max(1, -(-n // config.batch_size))
        self.num_features = bundle.number_features

        def upload(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        self._x_train, self._y_train = upload(bundle.x_train), upload(bundle.y_train)
        nv = min(bundle.x_valid.shape[0], config.max_val_points)
        if nv == 0:
            raise ValueError(
                f"No validation points available (x_valid has {bundle.x_valid.shape[0]} rows, "
                f"max_val_points={config.max_val_points}); the per-epoch validation pass "
                "needs at least one")
        if self.contrastive:
            # InfoNCE has a log(B) baseline: validate in training-sized chunks
            self._val_chunk = min(config.batch_size, nv)
            nv = max((nv // self._val_chunk) * self._val_chunk, self._val_chunk)
        else:
            self._val_chunk = nv
        self._x_valid, self._y_valid = upload(bundle.x_valid[:nv]), upload(bundle.y_valid[:nv])
        self._task_loss = None if self.contrastive else resolve_loss(bundle.loss)
        self._metric = (accuracy_for(bundle.loss)
                        if not self.contrastive and "accuracy" in tuple(bundle.metrics) else None)

    # ------------------------------------------------------------------ setup
    def init(self) -> tuple[TrainState, dict]:
        """A fresh optimizer over the current weights, epoch 0, and an empty
        history for ``config.num_epochs`` epochs."""
        params = nn.ModuleDict({"model": self.model})
        if self.y_encoder is not None:
            params["y_encoder"] = self.y_encoder
        optimizer, schedule = make_optimizer(self.config, params.parameters())
        history = history_init(self.config.num_epochs, self.num_features, self.device,
                               self.replicas)
        return TrainState(params, optimizer, schedule, 0), history

    # -------------------------------------------------------------- loss core
    def _per_replica(self, fn):
        """``fn`` reduces over every axis it is given; with replicas it is
        mapped over the replica axis, so each replica is reduced alone."""
        return fn if self.replicas is None else torch.func.vmap(fn)

    def _forward_loss(self, x, y, beta, eps):
        prediction, aux = self.model(x, eps=eps)
        kl_per_feature = aux["kl_per_feature"]
        if self.contrastive:
            task = symmetric_infonce(prediction, self.y_encoder(y),
                                     self.config.infonce_similarity,
                                     self.config.infonce_temperature)
        else:
            task = self._per_replica(self._task_loss)(prediction, y)
        loss = task + beta * kl_per_feature.sum(-1)
        metric = (self._per_replica(self._metric)(prediction, y) if self._metric is not None
                  else torch.zeros(kl_per_feature.shape[:-1], device=self.device))
        return loss, {"task": task, "kl": kl_per_feature, "metric": metric}

    def train_step(self, state: TrainState, x, y, beta, eps) -> dict:
        """One update on batch (x, y) with the encoders' noise ``eps``;
        returns the step's detached statistics. With replicas, x, y, eps and
        beta ([R]) lead with the replica axis, and the gradient is that of
        the sum of the replicas' losses: replica r's weights get only its own."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, stats = self._forward_loss(x, y, beta, eps)
        (loss if self.replicas is None else loss.sum()).backward()
        state.optimizer.step()
        state.schedule.step()
        return {name: value.detach() for name, value in stats.items()}

    # ------------------------------------------------------------------ epoch
    def _betas(self, start: int, num_epochs: int):
        """The beta of each of ``num_epochs`` epochs from epoch ``start``,
        from the config's schedule. Each is a float32 value as a Python
        float: the loss multiplies it in float32 and no host-to-device copy
        waits on the stream. A sweep gives one [R] row per epoch instead."""
        cfg = self.config
        return [float(log_annealed_beta(epoch, cfg.beta_start, cfg.beta_end,
                                        cfg.num_annealing_epochs, cfg.num_pretraining_epochs))
                for epoch in range(start, start + num_epochs)]

    def _epoch_body(self, state: TrainState, draws, beta) -> dict:
        """One epoch at ``beta`` (one of ``_betas``). With replicas,
        ``draws`` gives indices [steps, R, B] and noise of the model's
        ``noise_shape``."""
        cfg = self.config
        idx = draws.start_epoch(self._x_train.shape[0], self.steps_per_epoch,
                                cfg.batch_size, cfg.batch_sampling).to(self.device)
        steps = []
        for step in range(self.steps_per_epoch):
            rows = idx[step]
            eps = draws.step_noise(step, self.model.noise_shape(cfg.batch_size))
            steps.append(self.train_step(state, self._x_train[rows], self._y_train[rows],
                                         beta, eps))
        state.epoch += 1
        val_loss, val_metric = self.validate(beta, draws)
        return {
            "beta": beta,
            "kl_per_feature": torch.stack([s["kl"] for s in steps]).mean(0),
            "loss": torch.stack([s["task"] for s in steps]).mean(0),
            "val_loss": val_loss,
            "metric": torch.stack([s["metric"] for s in steps]).mean(0),
            "val_metric": val_metric,
        }

    def validate(self, beta, draws):
        """The task loss and metric on the validation rows, in one forward
        (training-sized chunks for InfoNCE); with replicas every replica
        sees every row, [R] each."""
        num_chunks = self._x_valid.shape[0] // self._val_chunk
        val_task, val_metric = [], []
        with torch.no_grad():
            for chunk in range(num_chunks):
                rows = slice(chunk * self._val_chunk, (chunk + 1) * self._val_chunk)
                x, y = self._x_valid[rows], self._y_valid[rows]
                if self.replicas is not None:
                    x, y = (t.expand(self.replicas, *t.shape) for t in (x, y))
                eps = draws.val_noise(chunk, num_chunks, self.model.noise_shape(self._val_chunk))
                _, aux = self._forward_loss(x, y, beta, eps)
                val_task.append(aux["task"])
                val_metric.append(aux["metric"])
        return torch.stack(val_task).mean(0), torch.stack(val_metric).mean(0)

    def run_chunk(self, state: TrainState, history: dict, draws, num_epochs: int):
        """Train ``num_epochs`` epochs, recording one history row each."""
        for beta in self._betas(state.epoch, num_epochs):
            history = history_record(history, self._epoch_body(state, draws, beta))
        return state, history

    def _make_draws(self, generator, draws):
        """The draws object ``fit`` trains from."""
        return GeneratorDraws(self.as_generator(generator)) if draws is None else draws

    def as_generator(self, generator) -> torch.Generator:
        """A generator on the trainer's device: ``generator`` itself, or one
        set to a saved state (the uint8 tensor a checkpoint restores)."""
        if isinstance(generator, torch.Generator):
            return generator
        restored = torch.Generator(device=self.device)
        restored.set_state(torch.as_tensor(generator, dtype=torch.uint8).cpu())
        return restored

    def _records(self, history: dict):
        """What ``fit`` returns of the history."""
        return HistoryRecord.from_device(history)

    def _param_norms(self, params) -> torch.Tensor:
        """The parameters' global L2 norm (the anomaly detector's stand-in
        for a gradient norm); a sweep's is one norm per member, [R]."""
        if self.replicas is None:
            return torch.linalg.vector_norm(torch.stack([p.detach().norm()
                                                         for p in params.parameters()]))
        model = params["model"]
        squares = [model.member_axis(name, p.detach()).reshape(self.replicas, -1).pow(2).sum(1)
                   for name, p in model.named_parameters()]
        return torch.stack(squares).sum(0).sqrt()

    def boundary_row(self, state: TrainState, history: dict) -> dict:
        """The last recorded row (beta, loss, val_loss, kl_per_feature) and
        the parameter norm, fetched to the host in one copy: float64 numpy
        arrays, with a leading replica axis for a sweep."""
        at = (slice(None),) * (history["beta"].dim() - 1) + (history["cursor"] - 1,)
        parts = {name: history[name][at] for name in ("beta", "loss", "val_loss",
                                                      "kl_per_feature")}
        parts["param_norm"] = self._param_norms(state.params)
        lead = () if self.replicas is None else (self.replicas,)
        flat = torch.cat([v.detach().reshape(*lead, -1) for v in parts.values()],
                         dim=-1).cpu().numpy().astype(np.float64)
        row, start = {}, 0
        for name, value in parts.items():
            width = int(np.prod(value.shape[len(lead):], dtype=np.int64))
            row[name] = flat[..., start:start + width].reshape(value.shape)
            start += width
        return row

    def _chunk_fields(self, row: dict) -> dict:
        """The boundary row as a ``chunk`` event's fields."""
        return {"beta": float(row["beta"]), "loss": float(row["loss"]),
                "val_loss": float(row["val_loss"]),
                "kl_per_feature": [float(x) for x in row["kl_per_feature"]]}

    def _chunk_tags(self) -> dict:
        """Tags of each chunk span (a sweep's name its replicas and betas)."""
        return {}

    def _new_guard(self) -> dict:
        """The divergence guard's memory for one fit."""
        from dib_tpu_torch.train.anomaly import BoundaryAnomalyDetector

        return {"detector": BoundaryAnomalyDetector.for_config(self.config), "warned": False,
                "rollback": {"epoch": None, "step": None, "quarantines": 0}}

    def _finish_fit(self, guard) -> None:
        """Runs once a fit's loop ends; a sweep records its ejected members."""

    def _check_boundary(self, guard, state, history, row, draws, hooks, telemetry, chunk,
                        start_epoch):
        """Judge the boundary row; on a finding, roll back to the newest
        intact checkpoint (or warn once when there is none). Returns
        ``(state, history, replayed)``: ``replayed`` sends the fit back to
        the restored epoch, past this boundary's hooks and faults."""
        from dib_tpu_torch.train.anomaly import boundary_channels
        from dib_tpu_torch.train.checkpoint import find_checkpointer

        epoch = int(state.epoch)
        findings = guard["detector"].observe(epoch, boundary_channels(
            row, param_norm=row["param_norm"]))
        if not findings:
            return state, history, False
        mtype = ("anomaly_rollback" if all(f.kind == "spike" for f in findings)
                 else "divergence_rollback")
        if telemetry is not None:
            for f in findings:
                telemetry.anomaly(epoch=epoch, channel=f.channel, kind=f.kind, value=f.value,
                                  zscore=f.zscore, threshold=f.threshold, phase=f.phase)
        ckpt = find_checkpointer(hooks)
        if ckpt is not None and ckpt.latest_step is not None:
            state, history = self._rollback_divergence(
                ckpt, telemetry, chunk, row, epoch=epoch, start_epoch=start_epoch,
                rollback_ctx=guard["rollback"], mtype=mtype, draws=draws, hooks=hooks)
            guard["detector"].rewind(int(state.epoch))
            return state, history, True
        if not guard["warned"]:
            guard["warned"] = True
            self._warn_divergence_unrecoverable(telemetry, row, epoch=epoch, findings=findings)
        return state, history, False

    def _warn_divergence_unrecoverable(self, telemetry, row, *, epoch, findings=()):
        """A bad boundary with nothing to roll back to: say so, once."""
        spikes_only = bool(findings) and all(f.kind == "spike" for f in findings)
        what = "anomalous (finite-SDC-shaped)" if spikes_only else "non-finite"
        detail = _row_detail(row)
        if telemetry is not None:
            telemetry.mitigation(
                mtype="anomaly_detected" if spikes_only else "divergence_detected",
                epoch=epoch, action="none",
                reason="no checkpoint hook / saved step to roll back to", **detail)
        warnings.warn(f"{what} loss/KL at epoch {epoch} (loss={detail['loss']}); no checkpoint "
                      "to roll back to: training continues on a diverged state. Add a "
                      "CheckpointHook to fit(hooks=...) to roll back automatically.")

    def _rollback_divergence(self, ckpt, telemetry, chunk, row, *, epoch, start_epoch,
                             rollback_ctx, mtype, draws, hooks):
        """Restore the newest intact checkpoint into this trainer and the
        draws (``draws.restore``), and rewind the hooks that keep records
        past it; returns ``(state, history)``.

        A divergence that recurs at or before the last rollback's epoch
        means the restored step reproduces it: that step is quarantined and
        the rollback retried from an older one, up to
        ``_MAX_ROLLBACK_QUARANTINES`` times; past that (or when the step
        cannot be quarantined) the divergence is deterministic and this
        raises."""
        from dib_tpu_torch.train.checkpoint import fallback_reporter

        detail = _row_detail(row)
        last_epoch = rollback_ctx.get("epoch")
        if last_epoch is not None and epoch <= last_epoch:
            last_step = rollback_ctx.get("step")
            quarantines = rollback_ctx.get("quarantines", 0)
            if not (hasattr(ckpt, "quarantine_step") and last_step is not None
                    and quarantines < _MAX_ROLLBACK_QUARANTINES):
                raise RuntimeError(
                    f"training diverged again at epoch {epoch} after rolling back (previous "
                    f"divergence at epoch {last_epoch}"
                    + (f"; {quarantines} suspect checkpoint(s) already quarantined"
                       if quarantines else "")
                    + "): the trajectory diverges deterministically; lower the learning rate "
                    "or the beta ceiling, or resume from an earlier checkpoint.")
            reason = (f"restoring step {last_step} reproduced the anomaly at epoch {epoch}: the "
                      "checkpoint was written during an anomalous window and is not a safe "
                      "rollback target")
            try:
                qpath = ckpt.quarantine_step(last_step, reason)
            except OSError as exc:
                raise RuntimeError(
                    f"divergence recurred at epoch {epoch} and the suspect checkpoint step "
                    f"{last_step} could not be quarantined ({exc})") from exc
            rollback_ctx["quarantines"] = quarantines + 1
            if telemetry is not None:
                telemetry.quarantine(step=last_step, reason=reason, path=qpath, epoch=epoch,
                                     source="divergence rollback")
            warnings.warn(f"divergence recurred at epoch {epoch}: checkpoint step {last_step} "
                          f"reproduced it and was quarantined ({qpath}); retrying the rollback "
                          "from an older step")
        try:
            state, history, generators = ckpt.restore_latest_intact(
                self, chunk_size=chunk,
                on_fallback=fallback_reporter(telemetry, source="divergence rollback"))
        except Exception as exc:
            raise RuntimeError(
                f"divergence rollback failed: non-finite loss at epoch {epoch} and the "
                f"checkpoint at step {ckpt.latest_step} could not be restored "
                f"({type(exc).__name__}: {exc})") from exc
        restored_epoch = int(state.epoch)
        if restored_epoch < start_epoch:
            raise RuntimeError(
                f"divergence rollback refused: the latest checkpoint is at epoch "
                f"{restored_epoch}, before this fit's start epoch {start_epoch}: the checkpoint "
                "directory predates this fit. Restart the run from that checkpoint explicitly.")
        draws.restore(generators, restored_epoch)
        rewind_hooks(hooks, restored_epoch)
        if telemetry is not None:
            telemetry.mitigation(mtype=mtype, epoch=epoch, restored_epoch=restored_epoch,
                                 **detail)
        what = "anomalous (finite-SDC-shaped)" if mtype == "anomaly_rollback" else "non-finite"
        warnings.warn(f"{what} loss/KL at epoch {epoch}; rolled back to the chunk-aligned "
                      f"checkpoint at epoch {restored_epoch} (its weights, optimizer, history "
                      "and generator states)")
        rollback_ctx["epoch"] = epoch
        rollback_ctx["step"] = ckpt.latest_step
        return state, history

    # -------------------------------------------------------------------- fit
    def fit(self, generator: torch.Generator | None = None, num_epochs: int | None = None,
            hooks: Sequence[Callable] = (), hook_every: int = 0,
            state: TrainState | None = None, history: dict | None = None,
            draws=None, preempt=None, telemetry=None,
            fault_plan=None) -> tuple[TrainState, HistoryRecord]:
        """Train in chunks of ``hook_every`` epochs (0: one chunk, no hooks),
        calling each hook as ``hook(trainer, state, epoch)`` after a chunk.

        Draws come from ``generator`` (on the trainer's device, or a saved
        generator state, which continues that stream) or from a ``draws``
        object with :class:`GeneratorDraws`'s methods; give one of the two.
        A resumed run passes both ``state`` and ``history`` too.

        Before its hooks run, each chunk publishes ``resume_generators``,
        ``latest_history`` and ``resume_chunk`` for ``CheckpointHook``.
        ``preempt`` (a :class:`~dib_tpu_torch.train.preempt.PreemptionGuard`)
        is checked before each chunk, as the JAX package's fit checks it: a
        pending SIGTERM/SIGINT writes a final chunk-aligned checkpoint
        through the hooks' checkpointer (unless they just wrote it) and
        raises ``TrainingPreempted``.

        ``telemetry`` (an :class:`~dib_tpu_torch.telemetry.events.
        EventWriter`): a ``chunk`` span and event per chunk (the span waits
        for the chunk's device work), boundary and mid-chunk heartbeats,
        the guard's ``anomaly``, ``mitigation`` and ``quarantine`` events,
        ``fault`` events and a closing ``metrics`` event; nothing is
        written inside a chunk but the heartbeat thread's beats.

        Divergence guard: each boundary row is checked for non-finite
        values and anomalies. A bad boundary rolls back to the newest
        intact checkpoint of the hooks' checkpointer (the weights, Adam's
        moments and step, the LR schedule's position, the history and the
        generators' states) and replays from there: for a transient fault
        the replayed run equals the uninterrupted one bit for bit. Hooks
        with a ``rewind(epoch)`` drop what they recorded past the restored
        epoch. A divergence that recurs at the same epoch raises; without
        a checkpoint the guard warns once and training goes on.

        ``fault_plan`` (a :class:`~dib_tpu_torch.faults.plan.FaultPlan`)
        fires its due specs after each boundary's hooks, so a checkpoint
        hook has saved the clean state first.
        """
        from dib_tpu_torch.telemetry import trace
        from dib_tpu_torch.telemetry.hooks import FitRecorder

        if (generator is None) == (draws is None):
            raise ValueError("give exactly one of generator and draws")
        for hook in hooks:          # hooks refuse what they cannot run before any epoch
            if hasattr(hook, "check"):
                hook.check(self)
        draws = self._make_draws(generator, draws)
        num_epochs = self.config.num_epochs if num_epochs is None else num_epochs
        if (state is None) != (history is None):
            raise ValueError("Resuming needs BOTH state and history; got exactly one")
        if state is None:
            state, history = self.init()
        capacity, cursor = history["beta"].shape[-1], history["cursor"]
        if cursor + num_epochs > capacity:
            raise ValueError(
                f"History buffer holds {capacity} epochs but {cursor} are already recorded "
                f"and {num_epochs} more were requested; grow it with "
                "history_extend(history, n) or train fewer epochs.")
        recorder = FitRecorder(telemetry,
                               steps_per_epoch=self.steps_per_epoch * (self.replicas or 1))
        chunk = hook_every if hook_every else num_epochs
        generators = getattr(draws, "generators", None)
        start_epoch, done, chunk_index = int(state.epoch), 0, 0
        guard = self._new_guard()
        with trace.use_tracer(recorder.tracer), recorder.heartbeats():
            while done < num_epochs:
                if preempt is not None and preempt.requested:
                    from dib_tpu_torch.train.preempt import chunk_aligned_preempt_exit

                    chunk_aligned_preempt_exit(preempt, hooks, state, history, generators,
                                               chunk, telemetry=telemetry)
                this_chunk = min(chunk, num_epochs - done)
                with recorder.chunk_phase(**self._chunk_tags()) as phase:
                    state, history = self.run_chunk(state, history, draws, this_chunk)
                    phase.block_on(history["loss"])
                done += this_chunk
                chunk_index += 1
                self.resume_generators, self.latest_history, self.resume_chunk = (
                    generators, history, chunk)
                row = self.boundary_row(state, history)
                recorder.record_chunk(epoch=int(state.epoch), chunk_epochs=this_chunk,
                                      **self._chunk_fields(row))
                state, history, replayed = self._check_boundary(
                    guard, state, history, row, draws, hooks, telemetry, chunk, start_epoch)
                # a rollback or a quarantine replay moved these
                self.resume_generators, self.latest_history = generators, history
                if replayed:
                    done = int(state.epoch) - start_epoch
                    continue            # the diverged boundary: no hooks, no faults
                for hook in hooks:
                    hook(self, state, state.epoch)
                if fault_plan is not None and fault_plan.due(chunk_index):
                    from dib_tpu_torch.faults.inject import apply_due_train_faults

                    state = apply_due_train_faults(fault_plan, chunk_index, state, telemetry)
        recorder.finish()
        self._finish_fit(guard)
        return state, self._records(history)

    # ------------------------------------------------------------ inspection
    def encode_feature(self, state: TrainState, feature_index: int, x_feature):
        """One channel's (mus, logvars) on raw single-feature rows (numpy or
        a tensor), from the state's model, without gradients: [N, d] each
        ([R, N, d] for a model with replicas, every replica on the rows)."""
        x = torch.as_tensor(x_feature, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return state.params["model"].encode_feature(feature_index, x)

    def feature_data(self, feature_index: int, split: str = "valid",
                     arr: np.ndarray | None = None) -> np.ndarray:
        """One feature's columns, from a split or from ``arr`` (e.g. raw values)."""
        dims = list(self.bundle.feature_dimensionalities)
        start = int(np.sum(dims[:feature_index]))
        if arr is None:
            arr = self.bundle.x_valid if split == "valid" else self.bundle.x_train
        return arr[:, start:start + dims[feature_index]]


# ------------------------------------------------------- divergence guard
#: Suspect rollback targets one fit may quarantine before it declares the
#: divergence deterministic.
_MAX_ROLLBACK_QUARANTINES = 2


def _row_detail(row: dict) -> dict:
    """The diverged boundary row as a mitigation event's fields."""
    return {"loss": float(np.asarray(row["loss"]).ravel()[0]),
            "val_loss": float(np.asarray(row["val_loss"]).ravel()[0]),
            "kl_per_feature": [float(x) for x in np.asarray(row["kl_per_feature"]).ravel()]}


def rewind_hooks(hooks, epoch: int) -> None:
    """Call ``rewind(epoch)`` on every hook that has one (looking inside
    ``Every``, hook combinations and per-replica adapters): after a
    rollback to ``epoch`` each drops what it recorded past it and returns
    its draws to where they stood, so the replay measures what the
    uninterrupted run measured."""
    from dib_tpu_torch.train.checkpoint import iter_hooks

    for hook in iter_hooks(hooks):
        if callable(getattr(type(hook), "rewind", None)):
            hook.rewind(epoch)
