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
Left out of ``fit`` for now: telemetry, fault plans, the divergence guard
and its checkpoint rollback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

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

    def _after_chunk(self, state: TrainState, history: dict):
        """Runs after every chunk, before the hooks; a sweep checks its
        members here."""

    def _records(self, history: dict):
        """What ``fit`` returns of the history."""
        return HistoryRecord.from_device(history)

    # -------------------------------------------------------------------- fit
    def fit(self, generator: torch.Generator | None = None, num_epochs: int | None = None,
            hooks: Sequence[Callable] = (), hook_every: int = 0,
            state: TrainState | None = None, history: dict | None = None,
            draws=None, preempt=None) -> tuple[TrainState, HistoryRecord]:
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
        """
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
        chunk = hook_every if hook_every else num_epochs
        generators = getattr(draws, "generators", None)
        done = 0
        while done < num_epochs:
            if preempt is not None and preempt.requested:
                from dib_tpu_torch.train.preempt import chunk_aligned_preempt_exit

                chunk_aligned_preempt_exit(preempt, hooks, state, history, generators,
                                           chunk)
            this_chunk = min(chunk, num_epochs - done)
            state, history = self.run_chunk(state, history, draws, this_chunk)
            done += this_chunk
            self._after_chunk(state, history)
            self.resume_generators, self.latest_history, self.resume_chunk = (
                generators, history, chunk)
            for hook in hooks:
                hook(self, state, state.epoch)
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
