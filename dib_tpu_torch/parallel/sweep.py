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

After every chunk the stacked boundary row is fetched once and each
member is judged on its own: a member whose loss or KL is not finite, or
whose anomaly detector fires, is quarantined. The stacked checkpoint is
restored once, the gap is replayed at the original width, and only the bad
members' slices are spliced back (weights, Adam's moments, history rows,
generator states); a member that diverges again in the replay is ejected
and the sweep goes on with R - 1 live members. Without a checkpoint one
warning names the members and their beta endpoints and the sweep
continues. ``DIBCheckpointer`` saves and restores the stacked state with
the R members' generators; ``fit`` takes a ``PreemptionGuard``, an event
stream and a fault plan, as the serial trainer does. Not ported: meshes
and the shard_map engine (ROADMAP.md queue 1, item 7).
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

    def restore(self, generator_states, epoch: int) -> None:
        """Continue every member from a checkpoint's generator states."""
        for member, state in zip(self.members, generator_states):
            member.restore(state, epoch)


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
        self.ejected_replicas: dict[int, dict] = {}
        self._in_quarantine_replay = False

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

    def _chunk_tags(self) -> dict:
        return {"replicas": self.num_replicas,
                "beta_end": [float(b) for b in self.beta_ends_host]}

    def _chunk_fields(self, row: dict) -> dict:
        """The stacked boundary row as a ``chunk`` event's [R] lists."""
        return {"beta": row["beta"].tolist(), "loss": row["loss"].tolist(),
                "val_loss": row["val_loss"].tolist(),
                "kl_per_feature": row["kl_per_feature"].tolist(),
                "beta_ends": [float(b) for b in self.beta_ends_host]}

    def _new_guard(self) -> dict:
        from dib_tpu_torch.train.anomaly import BoundaryAnomalyDetector

        return {"detectors": [BoundaryAnomalyDetector.for_config(self.config)
                              for _ in range(self.num_replicas)],
                "ejected": {}, "warned": False}

    def _finish_fit(self, guard) -> None:
        self.ejected_replicas = guard["ejected"]

    def _records(self, histories: dict) -> list[HistoryRecord]:
        return sweep_records(histories, ejected=getattr(self, "ejected_replicas", {}))

    def _check_boundary(self, guard, states, histories, row, draws, hooks, telemetry, chunk,
                        start_epoch):
        """Judge every member's boundary row at once (non-finite values,
        then each live member's anomaly detector) and quarantine the bad
        members. Returns ``(states, histories, False)``: the hooks run on
        the healed stack."""
        from dib_tpu_torch.train.anomaly import boundary_channels

        epoch = int(states.epoch)
        ejected, detectors = guard["ejected"], guard["detectors"]
        beta_ends = [float(b) for b in self.beta_ends_host]
        nonfinite = set(_nonfinite_members(row))
        anomalous: dict[int, list] = {}
        for r in range(self.num_replicas):
            if r in ejected or r in nonfinite:
                continue
            findings = detectors[r].observe(epoch, _member_channels(row, r, boundary_channels))
            if findings:
                anomalous[r] = findings
                if telemetry is not None:
                    for f in findings:
                        telemetry.anomaly(epoch=epoch, channel=f.channel, kind=f.kind,
                                          value=f.value, zscore=f.zscore,
                                          threshold=f.threshold, phase=f.phase, replica=r,
                                          beta_end=beta_ends[r])
        bad = [r for r in sorted(nonfinite | set(anomalous)) if r not in ejected]
        if bad:
            states, histories = self._quarantine_divergence(
                bad, states, histories, draws, hooks, telemetry, chunk, guard, epoch=epoch,
                start_epoch=start_epoch, row=row, anomalous=anomalous)
        return states, histories, False

    def _quarantine_divergence(self, bad, states, histories, draws, hooks, telemetry, chunk,
                               guard, *, epoch, start_epoch, row, anomalous):
        """Heal (or eject) the members in ``bad``.

        Restores the stacked checkpoint once, replays the gap as one sweep
        at the original width R (where each member equals its slot of the
        uninterrupted stack bit for bit: cuBLAS picks its algorithms by
        shape), and splices back only the healed members: their slices of
        every stacked parameter and of Adam's moments, their history rows
        and their generators' states. The others keep their live values.
        A member still non-finite or anomalous after the replay diverges
        deterministically and is ejected. Returns ``(states, histories)``.
        """
        from dib_tpu_torch.train.anomaly import boundary_channels
        from dib_tpu_torch.train.checkpoint import fallback_reporter, find_checkpointer

        beta_ends = [float(b) for b in self.beta_ends_host]
        ejected, detectors = guard["ejected"], guard["detectors"]
        ckpt = find_checkpointer(hooks)
        if ckpt is None or ckpt.latest_step is None:
            if self._in_quarantine_replay:
                # the replay meeting the divergence it replays: the outer
                # quarantine reports the outcome
                return states, histories
            if not guard["warned"]:
                guard["warned"] = True
                if telemetry is not None:
                    telemetry.mitigation(mtype="divergence_detected", epoch=epoch,
                                         action="none", replicas=list(bad),
                                         beta_end=[beta_ends[r] for r in bad],
                                         reason="no checkpoint hook / saved step to roll back to")
                warnings.warn(
                    f"non-finite loss/KL at epoch {epoch} in sweep member(s) {bad} (beta_end "
                    f"{[beta_ends[r] for r in bad]}); no checkpoint to roll back to, so the "
                    "sweep continues with the diverged member(s). Add a CheckpointHook to "
                    "fit(hooks=...) to quarantine them.")
            return states, histories
        # the restore loads the checkpoint into the live modules: keep the
        # live weights (Adam's moments stay in the live optimizer)
        stacked = states.params["model"]
        live = {name: value.detach().clone() for name, value in stacked.state_dict().items()}
        try:
            st0, hi0, gens0 = ckpt.restore_latest_intact(
                self, chunk_size=chunk,
                on_fallback=fallback_reporter(telemetry, source="sweep quarantine"))
        except Exception as exc:
            stacked.load_state_dict(live)
            raise RuntimeError(
                f"sweep quarantine failed: non-finite loss at epoch {epoch} in member(s) {bad} "
                f"and the checkpoint at step {ckpt.latest_step} could not be restored "
                f"({type(exc).__name__}: {exc})") from exc
        restored_epoch = int(st0.epoch)
        if restored_epoch < start_epoch:
            stacked.load_state_dict(live)
            raise RuntimeError(
                f"sweep quarantine refused: the latest checkpoint is at epoch {restored_epoch}, "
                f"before this fit's start epoch {start_epoch}: the checkpoint directory "
                "predates this fit. Restart the run from that checkpoint explicitly.")
        gap = epoch - restored_epoch
        if gap <= 0:
            stacked.load_state_dict(live)
            for r in bad:
                self._eject_replica(r, ejected, telemetry, epoch=epoch, beta_end=beta_ends[r],
                                    reason="checkpointed state itself diverges (nothing to "
                                           "replay)")
            return states, histories
        self._in_quarantine_replay = True
        try:
            replay_states, _ = self.fit(gens0, num_epochs=gap, hook_every=chunk,
                                        states=st0, histories=hi0)
        finally:
            self._in_quarantine_replay = False
        replay_histories, replay_generators = self.latest_history, self.resume_generators
        healed_row = self.boundary_row(replay_states, replay_histories)
        still_bad = set(_nonfinite_members(healed_row))
        for r in bad:
            # forget what a flagged member's channels recorded at this
            # boundary: the recheck and the healed commit judge clean points
            detectors[r].rewind(epoch - 1)
        for r in anomalous:
            if detectors[r].observe(epoch, _member_channels(healed_row, r, boundary_channels),
                                    record=False):
                still_bad.add(r)
        replay_params = stacked.state_dict()       # the replay's weights, until the load below
        for r in bad:
            if r in still_bad:
                self._eject_replica(
                    r, ejected, telemetry, epoch=epoch, beta_end=beta_ends[r],
                    reason=("still anomalous after the quarantine replay" if r in anomalous
                            else "re-diverged during the quarantine replay"))
                continue
            for name, value in live.items():
                stacked.member_axis(name, value)[r] = stacked.member_axis(
                    name, replay_params[name])[r]
            _splice_optimizer(stacked, states.optimizer, replay_states.optimizer, r)
            for name, value in histories.items():
                if name != "cursor":
                    value[r] = replay_histories[name][r]
            draws.members[r].restore(replay_generators[r].get_state(), epoch)
            detectors[r].observe(epoch, _member_channels(healed_row, r, boundary_channels))
            was_anomalous = r in anomalous
            if telemetry is not None:
                telemetry.mitigation(
                    mtype="anomaly_rollback" if was_anomalous else "divergence_rollback",
                    epoch=epoch, replica=r, beta_end=beta_ends[r],
                    restored_epoch=restored_epoch, **_member_row_detail(row, r))
            what = "anomalous (finite-SDC-shaped)" if was_anomalous else "non-finite"
            warnings.warn(
                f"{what} loss/KL at epoch {epoch} in sweep member {r} (beta_end="
                f"{beta_ends[r]:g}); the member was rolled back to the checkpoint at epoch "
                f"{restored_epoch} and healed by a replay at the original width")
        stacked.load_state_dict(live)
        return states, histories

    def _eject_replica(self, r, ejected, telemetry, *, epoch, beta_end, reason) -> None:
        """Degrade the sweep to R-1 live members: the member's lane keeps
        computing (its NaNs cannot cross the replica axis) but is never
        healed again, and its record is marked ``ejected``."""
        ejected[r] = {"epoch": int(epoch), "beta_end": float(beta_end), "reason": reason}
        if telemetry is not None:
            telemetry.mitigation(mtype="replica_ejected", replica=r, epoch=int(epoch),
                                 beta_end=float(beta_end), reason=reason, scope="sweep")
        warnings.warn(
            f"sweep member {r} (beta_end={beta_end:g}) EJECTED at epoch {epoch}: {reason}. "
            f"The sweep continues with {self.num_replicas - len(ejected)} live member(s); its "
            "HistoryRecord is marked ejected.")

    def fit(self, generators: Sequence[torch.Generator] | None = None,
            num_epochs: int | None = None, hooks: Sequence[Callable] = (), hook_every: int = 0,
            states: TrainState | None = None, histories: dict | None = None,
            draws: Sequence | None = None, preempt=None, telemetry=None,
            fault_plan=None) -> tuple[TrainState, list[HistoryRecord]]:
        """``DIBTrainer.fit`` over the replicas: hooks are called as
        ``hook(sweep, states, epoch)``, draws come from R ``generators``
        (one per replica, on the device, or their saved states) or from R
        ``draws`` objects with ``GeneratorDraws``' methods. Returns the
        stacked states and one ``HistoryRecord`` per replica; the stacked
        history stays in ``latest_history``.

        The divergence guard works per member: a member whose boundary row
        is non-finite or anomalous is quarantined (``_quarantine_divergence``)
        when the hooks hold a checkpointer, and ejected when its replay
        diverges again (``ejected_replicas``, and its record's ``ejected``).
        ``telemetry`` and ``fault_plan`` are ``DIBTrainer.fit``'s; chunk
        events carry [R] lists."""
        return super().fit(generators, num_epochs, hooks, hook_every, states, histories, draws,
                           preempt, telemetry, fault_plan)

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

    @property
    def hooks(self) -> list[Callable]:
        """The replicas' hooks made so far (for rewinding after a rollback)."""
        return list(self.replica_hooks.values())

    def __call__(self, sweep: BetaSweepTrainer, states: TrainState, epoch: int):
        from dib_tpu_torch.telemetry import trace

        beta_ends = sweep.beta_ends_host
        for r in range(sweep.num_replicas):
            with trace.span(f"replica{r}", replica=r, beta_end=float(beta_ends[r]),
                            epoch=int(epoch)):
                state_r = sweep.replica_state(states, r)
                self._hook(r)(sweep.replica_trainer(r, state_r.params["model"]), state_r, epoch)


def sweep_records(histories: dict, ejected=()) -> list[HistoryRecord]:
    """Fetch a stacked [R, T, ...] history once and split it into one
    record per replica; the members in ``ejected`` are marked so."""
    host = {name: value.detach().cpu() for name, value in histories.items() if name != "cursor"}
    records = [HistoryRecord.from_device({**{name: value[r] for name, value in host.items()},
                                          "cursor": histories["cursor"]})
               for r in range(host["beta"].shape[0])]
    for r in ejected:
        records[r].ejected = True
    return records


# ----------------------------------------------------- quarantine plumbing
def _nonfinite_members(row: dict) -> list[int]:
    """Members whose fetched boundary loss, validation loss or KL is not
    finite."""
    bad: set[int] = set()
    for name in ("loss", "val_loss", "kl_per_feature"):
        finite = np.isfinite(row[name]).reshape(row[name].shape[0], -1).all(axis=1)
        bad.update(int(r) for r in np.flatnonzero(~finite))
    return sorted(bad)


def _member_channels(row: dict, r: int, boundary_channels) -> dict:
    """Member ``r``'s anomaly-detector channels from the stacked row."""
    member = {name: row[name][r] for name in ("loss", "val_loss", "kl_per_feature")}
    return boundary_channels(member, param_norm=float(row["param_norm"][r]))


def _member_row_detail(row: dict, r: int) -> dict:
    """Member ``r``'s diverged boundary row as a mitigation event's fields."""
    return {"loss": float(row["loss"][r]), "val_loss": float(row["val_loss"][r]),
            "kl_per_feature": [float(x) for x in row["kl_per_feature"][r]]}


def _splice_optimizer(model, live, replay, r: int) -> None:
    """Member ``r``'s slice of every stacked optimizer slot (Adam's
    moments) from ``replay`` into ``live``: both optimize ``model``'s
    parameters; step counts are shared by all members and equal."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            for slot, value in live.state.get(param, {}).items():
                if torch.is_tensor(value) and value.dim() >= 1:
                    model.member_axis(name, value)[r] = model.member_axis(
                        name, replay.state[param][slot])[r]
