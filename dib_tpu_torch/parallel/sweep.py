"""The beta sweep: a grid of DIB replicas trained as one stacked program
(counterpart of ``dib_tpu/parallel/sweep.py``, its vmap engine on one
device).

The JAX package vmaps its serial epoch over a replica axis. Here the axis
is explicit: the model is built with ``replicas=R`` (every parameter
stacked to [R, ...]), each batch, noise draw, beta and history row leads
with R, and ``BetaSweepTrainer`` is a ``DIBTrainer`` whose loss core, step
and fit loop train every replica at once; it replaces only the source of
beta (one per replica), the draws and the records, and checks its members
after every chunk. Attention has no weights, so the replicas share its batch
axis and one flash launch serves them all. Nothing reduces across the
replica axis: the backward pass takes the gradient of the sum of the
replicas' losses, which gives each replica's weights only its own, and
Adam is elementwise, so one ``torch.optim.Adam`` over the stacked leaves
is R independent Adams, under one shared warmup.

Each replica draws from its own generator, in the order the serial
``GeneratorDraws`` draws: replica r seeded with ``member_seed(seed, r)``
replays a serial ``DIBTrainer`` fed the same seed, to float tolerance.

After every chunk the stacked boundary row is fetched once; members whose
loss or KL is not finite are named, with their beta endpoints, in one
warning, and the sweep continues (the JAX branch taken when no checkpoint
exists). ``DIBCheckpointer`` saves and restores the stacked state with the
R members' generators, and ``fit`` takes a ``PreemptionGuard``, as the
serial trainer does. Not ported: the checkpoint rollback, replay and
ejection, the anomaly detectors, meshes and the shard_map engine,
telemetry and fault plans.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from dib_tpu_torch.ops.schedules import log_annealed_beta
from dib_tpu_torch.train.history import HistoryRecord
from dib_tpu_torch.train.loop import (
    DIBTrainer,
    GeneratorDraws,
    TrainConfig,
    TrainState,
    make_optimizer,
)

def member_seed(seed: int, r: int) -> int:
    """The seed of sweep member ``r`` of a run seeded with ``seed``: for its
    initial weights (a CPU generator) and for its draws."""
    return int(np.random.SeedSequence([seed, r]).generate_state(1)[0])


class StackedDraws:
    """The draws of R replicas, each from its own draws object with
    :class:`~dib_tpu_torch.train.loop.GeneratorDraws`' methods, stacked on
    a replica axis: indices [steps, R, B], noise [R, ...]."""

    def __init__(self, members: Sequence):
        self.members = list(members)

    @property
    def generators(self) -> list[torch.Generator] | None:
        """What a checkpoint saves to continue these draws (None unless
        every member draws from a generator)."""
        generators = [getattr(d, "generator", None) for d in self.members]
        return None if any(g is None for g in generators) else generators

    def start_epoch(self, n: int, steps: int, batch_size: int, sampling: str) -> torch.Tensor:
        return torch.stack([d.start_epoch(n, steps, batch_size, sampling)
                            for d in self.members], dim=1)

    def step_noise(self, step: int, shape) -> torch.Tensor:
        return torch.stack([d.step_noise(step, shape[1:]) for d in self.members])

    def val_noise(self, chunk: int, num_chunks: int, shape) -> torch.Tensor:
        return torch.stack([d.val_noise(chunk, num_chunks, shape[1:]) for d in self.members])


class BetaSweepTrainer(DIBTrainer):
    """Trains R replicas of a model over a grid of beta endpoints in one
    stacked program on one device: the serial trainer's data, loss core,
    step and fit loop, with one beta per replica and a check of the members
    after every chunk.

    Args:
      model: a model built with ``replicas=R`` (``PerParticleDIBModel``
        or ``DistributedIBModel``). Its weights are
        the replicas' initial weights: build it from R CPU generators
        (``generator=[...]``) to give each member the weights of a serial
        model from the same seed.
      bundle, config: as for ``DIBTrainer``; the endpoints below replace
        the config's.
      beta_starts, beta_ends: [R] endpoint grids (scalars broadcast to R).
      device: where it trains (``None`` means the GPU).
    """

    def __init__(self, model: nn.Module, bundle, config: TrainConfig, beta_starts, beta_ends,
                 *, device=None):
        starts, ends = np.broadcast_arrays(np.atleast_1d(np.asarray(beta_starts, np.float64)),
                                           np.atleast_1d(np.asarray(beta_ends, np.float64)))
        self.beta_starts_host, self.beta_ends_host = starts.copy(), ends.copy()
        self.num_replicas = len(starts)
        replicas = getattr(model, "replicas", None)
        if replicas != self.num_replicas:
            raise ValueError(
                f"the sweep has {self.num_replicas} beta endpoints and needs a model built with "
                f"replicas={self.num_replicas}; got {type(model).__name__} with replicas="
                f"{replicas}")
        super().__init__(model, bundle, config, device=device)

    def betas(self, epochs) -> torch.Tensor:
        """Every replica's beta at each of ``epochs``: [E, R] float32 on the
        device, one copy from the host."""
        cfg = self.config
        epochs = torch.as_tensor(epochs)
        return torch.stack([
            log_annealed_beta(epochs, float(s), float(e), cfg.num_annealing_epochs,
                              cfg.num_pretraining_epochs)
            for s, e in zip(self.beta_starts_host, self.beta_ends_host)], dim=-1).to(self.device)

    def _betas(self, start: int, num_epochs: int) -> torch.Tensor:
        return self.betas(torch.arange(start, start + num_epochs))

    def _make_draws(self, generators, draws) -> StackedDraws:
        members = ([GeneratorDraws(self.as_generator(g)) for g in generators] if draws is None
                   else list(draws))
        if len(members) != self.num_replicas:
            raise ValueError(f"expected {self.num_replicas} generators or draws, "
                             f"got {len(members)}")
        return StackedDraws(members)

    def _after_chunk(self, states: TrainState, histories: dict):
        """Fetch the boundary row of every member at once; warn once per fit
        naming the members whose loss or KL is no longer finite, and go on
        (no checkpoint to roll back to)."""
        self.latest_history = histories
        bad = _nonfinite_members(histories)
        if bad and not self._warned:
            self._warned = True
            warnings.warn(
                f"non-finite loss/KL at epoch {states.epoch} in sweep member(s) {bad} "
                f"(beta_end {[float(self.beta_ends_host[r]) for r in bad]}); no checkpoint "
                "to roll back to, so the sweep continues with the diverged member(s)")

    def _records(self, histories: dict) -> list[HistoryRecord]:
        return sweep_records(histories)

    def fit(self, generators: Sequence[torch.Generator] | None = None,
            num_epochs: int | None = None, hooks: Sequence[Callable] = (), hook_every: int = 0,
            states: TrainState | None = None, histories: dict | None = None,
            draws: Sequence | None = None,
            preempt=None) -> tuple[TrainState, list[HistoryRecord]]:
        """``DIBTrainer.fit`` over the replicas: hooks are called as
        ``hook(sweep, states, epoch)``, draws come from R ``generators``
        (one per replica, on the device, or their saved states) or from R
        ``draws`` objects with ``GeneratorDraws``' methods. Returns the
        stacked states and one ``HistoryRecord`` per replica; the stacked
        history stays in ``latest_history``."""
        self._warned = False
        return super().fit(generators, num_epochs, hooks, hook_every, states, histories, draws,
                           preempt)

    # ------------------------------------------------------------ inspection
    def _carve(self, states: TrainState, members) -> TrainState:
        """Members of the stacked state as a state of their own: the model
        carved out, Adam's moments sliced, the schedule copied."""
        stacked = states.params["model"]
        model = stacked.carve(members)
        optimizer, schedule = make_optimizer(self.config, model.parameters())
        names = [name for name, _ in stacked.named_parameters()]
        saved = states.optimizer.state_dict()
        saved["state"] = {i: {k: (v.clone() if k == "step" else
                                  stacked.member_values(names[i], v, members).clone())
                              for k, v in slot.items()}
                          for i, slot in saved["state"].items()}
        optimizer.load_state_dict(saved)
        schedule.load_state_dict(states.schedule.state_dict())
        return TrainState(nn.ModuleDict({"model": model}), optimizer, schedule, states.epoch)

    def replica_state(self, states: TrainState, r: int) -> TrainState:
        """Replica ``r``'s state as a serial one (a copy, taken now)."""
        return self._carve(states, r)

    def replica_trainer(self, r: int, model: nn.Module | None = None) -> DIBTrainer:
        """A serial-trainer view of replica ``r``: the sweep's data and
        loss plumbing with r's beta endpoints in its config, so serial hooks
        that read ``trainer.config`` see r's schedule. Its model is
        ``model`` (a serial model, as ``replica_state`` gives), else replica
        r of the current weights carved out."""
        view = DIBTrainer.__new__(DIBTrainer)
        view.__dict__.update(self.__dict__)
        view.config = dataclasses.replace(self.config,
                                          beta_start=float(self.beta_starts_host[r]),
                                          beta_end=float(self.beta_ends_host[r]))
        view.model = self.model.carve(r) if model is None else model
        view.replicas = None
        return view

    def recover_replica(self, states: TrainState, histories: dict, r: int):
        """Carve member ``r`` out for a run of its own: returns ``(sub_sweep,
        state_r, history_r)``, each keeping a replica axis of 1; continue it
        with ``sub_sweep.fit([generator_r], n, states=state_r,
        histories=history_r)``, ``generator_r`` the member's own generator as
        the sweep left it. The member then trains as it would have in the
        full sweep, to float tolerance (other widths batch other matmuls)."""
        state_r = self._carve(states, [r])
        sub = BetaSweepTrainer(state_r.params["model"], self.bundle, self.config,
                               self.beta_starts_host[r:r + 1], self.beta_ends_host[r:r + 1],
                               device=self.device)
        history_r = {name: (value[r:r + 1].clone() if name != "cursor" else value)
                     for name, value in histories.items()}
        return sub, state_r, history_r


class PerReplicaHook:
    """Adapts a serial-trainer hook to sweeps: one instance per replica,
    each called with that replica's trainer view and state, whose model is a
    serial model loaded from replica r at each call.

        hook = PerReplicaHook(lambda r: InfoPerFeatureHook(1024, 4, seed=r))
        sweep.fit(generators, hooks=[hook], hook_every=25)
    """

    def __init__(self, make_hook: Callable[[int], Callable]):
        self.make_hook = make_hook
        self.replica_hooks: dict[int, Callable] = {}

    def _hook(self, r: int) -> Callable:
        if r not in self.replica_hooks:
            self.replica_hooks[r] = self.make_hook(r)
        return self.replica_hooks[r]

    def check(self, sweep: BetaSweepTrainer):
        """Lets each replica's hook refuse what it cannot run, before any
        epoch (``fit`` calls it)."""
        for r in range(sweep.num_replicas):
            if hasattr(self._hook(r), "check"):
                self._hook(r).check(sweep.replica_trainer(r))

    def __call__(self, sweep: BetaSweepTrainer, states: TrainState, epoch: int):
        for r in range(sweep.num_replicas):
            state_r = sweep.replica_state(states, r)
            self._hook(r)(sweep.replica_trainer(r, state_r.params["model"]), state_r, epoch)


def sweep_records(histories: dict) -> list[HistoryRecord]:
    """Fetch a stacked [R, T, ...] history once and split it into one
    record per replica."""
    host = {name: value.detach().cpu() for name, value in histories.items() if name != "cursor"}
    return [HistoryRecord.from_device({**{name: value[r] for name, value in host.items()},
                                       "cursor": histories["cursor"]})
            for r in range(host["beta"].shape[0])]


def _nonfinite_members(histories: dict) -> list[int]:
    """Replica indices whose last recorded loss, validation loss or KL is
    not finite; the boundary row of every replica is fetched at once."""
    at = histories["cursor"] - 1
    row = torch.cat([histories[name][:, at].reshape(histories["beta"].shape[0], -1)
                     for name in ("loss", "val_loss", "kl_per_feature")], dim=1)
    return torch.nonzero(~torch.isfinite(row.cpu()).all(dim=1)).flatten().tolist()
