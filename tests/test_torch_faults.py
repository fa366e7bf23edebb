"""The port's fault plans, anomaly detector, divergence rollback and sweep
quarantine against the JAX package's.

Fault plans: the same spec strings parse to the same specs (kind, chunk,
argument, fired-once marker) and both packages reject the same invalid
ones. The anomaly detector gives the same findings on the same seeded
boundary series. The rollback: a tiny ``DistributedIBModel`` on the boolean
circuit, 2 + 2 epochs of one chunk each with a checkpoint per chunk and
``nan@chunk2``, resumed by both fits from the same carried weights and fed
the JAX key chain; the port's rolled-back history equals the JAX fit's to
1e-5 (the trainer's tolerance, ``test_torch_train.py``), its event stream
(read by the JAX ``read_events``, valid under the JAX ``EVENT_SCHEMA``)
has the JAX stream's sequence of event types less ``compile`` (eager
PyTorch compiles no chunk program) and the same anomaly channels and
mitigation fields; with generator draws the rolled-back run equals the
uninterrupted one bit for bit. The sweep: three members, members 0 and 1
poisoned once and member 1 again in every restore: member 0 is healed and
member 1 ejected, with the JAX sweep's fault and mitigation events; members
0 and 2 stay bit-equal to an uninterrupted sweep.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.faults import FaultPlan as JaxFaultPlan
from dib_tpu.faults import PoisonedReplicaRestore as JaxPoisonedRestore
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.parallel.sweep import BetaSweepTrainer as JaxSweep
from dib_tpu.telemetry.events import EVENT_SCHEMA as JAX_SCHEMA
from dib_tpu.telemetry.events import EventWriter as JaxWriter
from dib_tpu.telemetry.events import read_events as jax_read_events
from dib_tpu.train.anomaly import BoundaryAnomalyDetector as JaxDetector
from dib_tpu.train.checkpoint import CheckpointHook as JaxCheckpointHook
from dib_tpu.train.checkpoint import DIBCheckpointer as JaxCheckpointer
from dib_tpu.train.history import history_init as jax_history_init
from dib_tpu.train.loop import DIBTrainer as JaxTrainer
from dib_tpu.train.loop import TrainConfig as JaxTrainConfig
from dib_tpu.train.loop import TrainState as JaxTrainState
from dib_tpu_torch import interop
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.faults import (
    FaultPlan,
    PoisonedReplicaRestore,
    corrupt_checkpoint,
    poison_params,
    poison_replica_params,
    scale_params,
    scale_replica_params,
)
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.parallel import BetaSweepTrainer, member_seed
from dib_tpu_torch.telemetry import EventWriter, read_events, validate_event
from dib_tpu_torch.train import (
    CheckpointCorruptionError,
    CheckpointHook,
    DIBCheckpointer,
    DIBTrainer,
    TrainConfig,
)
from dib_tpu_torch.train.anomaly import BoundaryAnomalyDetector, boundary_channels
from test_torch_train import HISTORY, JaxKeyReplay

torch.set_num_threads(1)

TOL = 1e-5
DIB = dict(encoder_hidden=(8,), integration_hidden=(8,), output_dim=1, embedding_dim=4)
SETTINGS = dict(learning_rate=1e-3, batch_size=8, beta_start=1e-3, beta_end=1e-1,
                num_pretraining_epochs=2, num_annealing_epochs=2, steps_per_epoch=2,
                max_val_points=64)
EPOCHS = 4
ENDS = (1e-2, 1e-1, 1.0)


@pytest.fixture(autouse=True, scope="module")
def no_heartbeat_thread():
    """Boundary beats only (the mid-chunk thread's beats depend on timing),
    and no cost analysis in the JAX fits: its ``compile`` event is the one
    the port does not write, and it compiles the chunk program twice."""
    from dib_tpu.telemetry.hooks import FitRecorder as JaxRecorder

    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("DIB_HEARTBEAT_S", "0")
        patch.setattr(JaxRecorder, "record_compile", lambda *args, **kwargs: None)
        yield


# ---------------------------------------------------------------- plans

VALID = ["stall@chunk3:45s", "kill@chunk5", "nan@chunk7", "inf@chunk1",
         "replica_nan@chunk2:5", "preempt@chunk4", "sdc@chunk3:4", "replica_sdc@chunk2:1",
         "stall@chunk3:45s,kill@chunk5,nan@chunk7", " nan@chunk2 , kill@chunk4 ",
         "stall@chunk2:0.5", ""]
INVALID = ["nan@2", "bogus@chunk1", "stall@chunk3", "replica_nan@chunk2", "sdc@chunk1",
           "ckpt_truncate@chunk1", "replica_error@chunk1:2", "nan@chunkx", "nan",
           "kill@chunk1:s:s", "desync@chunk1", "journal_torn@chunk2"]


@pytest.mark.parametrize("text", VALID)
def test_plans_parse_as_the_jax_package_parses_them(text):
    def specs(plan):
        return [(s.kind, s.chunk, s.arg, s.raw, s.marker) for s in plan.specs]

    assert specs(FaultPlan.parse(text)) == specs(JaxFaultPlan.parse(text))


@pytest.mark.parametrize("text", INVALID)
def test_plans_both_packages_refuse(text):
    with pytest.raises(ValueError):
        JaxFaultPlan.parse(text)
    with pytest.raises(ValueError):
        FaultPlan.parse(text)


def test_a_fired_spec_stays_fired_across_launches(tmp_path, monkeypatch):
    monkeypatch.setenv("DIB_FAULT_PLAN", "kill@chunk2,nan@chunk3")
    monkeypatch.setenv("DIB_FAULT_STATE_DIR", str(tmp_path / "marks"))
    plan = FaultPlan.from_env(state_dir=str(tmp_path / "ignored"))
    (kill,) = plan.due(2)
    plan.mark_fired(kill)
    relaunched = FaultPlan.from_env()
    assert relaunched.due(2) == [] and [s.kind for s in relaunched.due(3)] == ["nan"]
    assert os.listdir(tmp_path / "marks") == [kill.marker]
    monkeypatch.delenv("DIB_FAULT_PLAN")
    assert FaultPlan.from_env() is None


# ------------------------------------------------------------- detector

def _series(seed, length=40):
    """Boundary channels of a slowly improving run with spikes, a collapse
    (a transition: never a fault) and a NaN."""
    rng = np.random.default_rng(seed)
    loss = 2.0 * np.exp(-np.arange(length) / 15) + rng.normal(0, 0.01, length)
    kl = 3.0 + rng.normal(0, 0.02, (length, 3))
    loss[12] += 5.0                 # spike, pretraining
    kl[25:, 1] = 1e-8               # KL collapse during annealing
    kl[30, 2] += 40.0               # spike, annealing
    loss[35] = np.nan
    norm = 10 + np.cumsum(rng.normal(0, 0.01, length))
    norm[20] *= 0.1                 # two-sided: a collapse of the norm is suspect
    return [({"loss": loss[i], "val_loss": loss[i] + 0.1, "kl_per_feature": kl[i]}, norm[i])
            for i in range(length)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_detector_finds_what_the_jax_detector_finds(seed):
    from dib_tpu.train.anomaly import boundary_channels as jax_channels

    ours, theirs = BoundaryAnomalyDetector(20), JaxDetector(20)
    fired = []
    for epoch, (row, norm) in enumerate(_series(seed), start=1):
        a = ours.observe(epoch, boundary_channels(row, param_norm=norm))
        b = theirs.observe(epoch, jax_channels(row, param_norm=norm))
        assert [(f.channel, f.kind, f.zscore, f.threshold, f.phase) for f in a] == \
            [(f.channel, f.kind, f.zscore, f.threshold, f.phase) for f in b], epoch
        fired += [(epoch, f.channel, f.kind) for f in a]
        if epoch == 28:
            ours.rewind(24)
            theirs.rewind(24)
    assert (13, "loss", "spike") in fired and (36, "loss", "nonfinite") in fired
    assert not any(channel == "kl/1" for _, channel, _ in fired)


# ------------------------------------------------------------ executors

def _model(replicas=None, seed=0):
    dims = tuple(get_dataset("boolean_circuit").feature_dimensionalities)
    generator = (torch.Generator().manual_seed(seed) if replicas is None else
                 [torch.Generator().manual_seed(member_seed(seed, r)) for r in range(replicas)])
    return DistributedIBModel(dims, **DIB, device="cpu", generator=generator, replicas=replicas)


def test_executors_corrupt_what_the_jax_executors_corrupt():
    model = _model()
    first = sorted(model.named_parameters())[0][0]
    params = torch.nn.ModuleDict({"model": model})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    poison_params(params, float("nan"))
    for name, value in model.state_dict().items():
        assert torch.isnan(value).all() if name == first else torch.equal(value, before[name])
    # the JAX package poisons the first leaf in path order: the same leaf
    jax_params = interop.params_to_flax(_model())
    first_path = jax.tree_util.tree_flatten_with_path(jax_params)[0][0][0]
    assert "encoders" in first.split(".")[0] and "encoders" in jax.tree_util.keystr(first_path)
    scale_params(params, 2.0)
    stacked = _model(replicas=3)
    params = torch.nn.ModuleDict({"model": stacked})
    before = {k: v.clone() for k, v in stacked.state_dict().items()}
    scale_replica_params(params, 2, 4.0)
    poison_replica_params(params, 1, float("inf"))
    for name, value in stacked.state_dict().items():
        for r in range(3):
            got, want = (stacked.member_values(name, v, r) for v in (value, before[name]))
            if r == 0 or (r == 1 and name != sorted(dict(stacked.named_parameters()))[0]):
                assert torch.equal(got, want), (name, r)
            elif r == 2:
                assert torch.equal(got, 4.0 * want), name
            else:
                assert torch.isinf(got).all()
    with pytest.raises(ValueError, match="out of range"):
        poison_replica_params(params, 3, 0.0)


@pytest.mark.parametrize("mode", ["ckpt_truncate", "ckpt_bitflip_manifest",
                                  "ckpt_bitflip_payload"])
def test_corrupt_steps_are_quarantined_and_the_one_before_restored(tmp_path, mode):
    bundle = get_dataset("boolean_circuit")
    trainer = DIBTrainer(_model(), bundle, TrainConfig(**SETTINGS), device="cpu")
    ckpt = DIBCheckpointer(str(tmp_path / "ckpt"))
    trainer.fit(torch.Generator().manual_seed(0), num_epochs=2, hooks=[CheckpointHook(ckpt)],
                hook_every=1)
    writer = EventWriter(str(tmp_path))
    detail = corrupt_checkpoint(ckpt.directory, mode, telemetry=writer)
    assert detail["step_dir"].endswith(os.sep + "2")
    with pytest.raises(CheckpointCorruptionError):
        ckpt.restore(trainer, step=2)
    from dib_tpu_torch.train.checkpoint import fallback_reporter

    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        state, _, _ = ckpt.restore_latest_intact(
            trainer, on_fallback=fallback_reporter(writer, source="test"))
    writer.close()
    assert state.epoch == 1 and ckpt.all_steps() == [1]
    kinds = [(e["type"], e.get("kind") or e.get("mtype")) for e in read_events(str(tmp_path))]
    assert kinds == [("fault", mode), ("mitigation", "checkpoint_fallback"),
                     ("quarantine", None)]


# ------------------------------------------------------------- rollback

class RewindableReplay(JaxKeyReplay):
    """The JAX key chain of an uninterrupted fit, which a rollback puts back
    at the restored epoch (the JAX fit re-derives the same keys from the
    checkpoint's key). ``generator`` is a placeholder a checkpoint saves."""

    def __init__(self, key, num_epochs, hook_every):
        super().__init__(key, num_epochs, hook_every)
        self.all_keys = list(self.epoch_keys)
        self.generator = torch.Generator()

    @property
    def generators(self):
        return [self.generator]

    def restore(self, generator_state, epoch):
        self.epoch_keys = self.all_keys[epoch:]


def _jax_fit(tmp, model, plan):
    jax_bundle = jax_get_dataset("boolean_circuit")
    trainer = JaxTrainer(JaxDIB(feature_dimensionalities=tuple(
        jax_bundle.feature_dimensionalities), **DIB), jax_bundle, JaxTrainConfig(**SETTINGS))
    trainer.init = jax.jit(trainer.init)     # the restore's template: one compile, not per op
    init = {"model": interop.params_to_flax(model)}
    state = JaxTrainState(init, trainer.optimizer.init(init), jnp.zeros((), jnp.int32))
    writer = JaxWriter(str(tmp), process_index=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, history = trainer.fit(
            jax.random.key(11), hook_every=1, state=state,
            history=jax_history_init(EPOCHS, jax_bundle.number_features),
            hooks=[JaxCheckpointHook(JaxCheckpointer(str(tmp / "ckpt")))], telemetry=writer,
            fault_plan=JaxFaultPlan.parse(plan))
    writer.close()
    return history, list(jax_read_events(str(tmp)))


def _port_fit(tmp, plan, draws=None, model=None):
    model = _model() if model is None else model
    trainer = DIBTrainer(model, get_dataset("boolean_circuit"), TrainConfig(**SETTINGS),
                         device="cpu")
    writer = EventWriter(str(tmp))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, history = trainer.fit(
            None if draws is not None else torch.Generator().manual_seed(5), draws=draws,
            hook_every=1, hooks=[CheckpointHook(DIBCheckpointer(str(tmp / "ckpt")))],
            telemetry=writer, fault_plan=FaultPlan.parse(plan) if plan else None)
    writer.close()
    return state, history, list(read_events(str(tmp))), [str(w.message) for w in caught]


@pytest.fixture(scope="module")
def rollback(tmp_path_factory):
    root = tmp_path_factory.mktemp("rollback")
    for name in ("jax", "port", "clean", "fault"):
        (root / name).mkdir()
    jax_history, jax_events = _jax_fit(root / "jax", _model(), "nan@chunk2")
    _, history, events, messages = _port_fit(
        root / "port", "nan@chunk2", draws=RewindableReplay(jax.random.key(11), EPOCHS, 1))
    clean = _port_fit(root / "clean", None)
    fault = _port_fit(root / "fault", "nan@chunk2")
    return dict(jax_history=jax_history, jax_events=jax_events, history=history,
                events=events, messages=messages, clean=clean, fault=fault, root=root)


def test_the_rolled_back_history_matches_the_jax_fit(rollback):
    for name in HISTORY:
        np.testing.assert_allclose(getattr(rollback["history"], name),
                                   getattr(rollback["jax_history"], name), rtol=TOL, atol=TOL,
                                   err_msg=name)
    assert np.isfinite(rollback["history"].loss).all()
    assert any("rolled back to the chunk-aligned checkpoint at epoch 2" in m
               for m in rollback["messages"])


def test_a_transient_fault_rolls_back_bit_for_bit(rollback):
    clean_state, clean_history = rollback["clean"][:2]
    state, history = rollback["fault"][:2]
    for name in HISTORY:
        assert np.array_equal(getattr(history, name), getattr(clean_history, name)), name
    for name, value in clean_state.params.state_dict().items():
        assert torch.equal(state.params.state_dict()[name], value), name
    for got, want in zip(state.optimizer.state.values(), clean_state.optimizer.state.values()):
        for slot in want:
            assert torch.equal(got[slot], want[slot]), slot
    assert state.schedule.last_epoch == clean_state.schedule.last_epoch


def test_the_event_stream_matches_the_jax_stream(rollback):
    ours = rollback["events"]
    theirs = rollback["jax_events"]
    assert [e["type"] for e in ours] == [e["type"] for e in theirs]
    for got, want in zip(ours, theirs):
        if got["type"] == "mitigation":
            assert set(got) == set(want) and got["mtype"] == want["mtype"] == \
                "divergence_rollback" and (got["epoch"], got["restored_epoch"]) == (3, 2)
        if got["type"] in ("anomaly", "fault", "heartbeat"):
            keys = ("channel", "kind", "epoch", "spec", "chunk", "phase", "beat")
            assert {k: got.get(k) for k in keys} == {k: want.get(k) for k in keys}
    # the port's stream through the JAX reader, and valid under its schema
    read_back = list(jax_read_events(str(rollback["root"] / "port")))
    assert read_back == ours
    for event in read_back:
        assert validate_event(event, JAX_SCHEMA) == [], event
    assert read_back[-1]["type"] == "metrics"


def test_a_divergence_that_recurs_raises(tmp_path):
    """A poison at epoch 2 that the checkpoint there holds: each replay
    diverges at epoch 3 again, the suspect steps are quarantined, then it
    raises."""
    def poison_at_2(trainer, state, epoch):
        if epoch == 2:
            poison_params(state.params, float("nan"))

    trainer = DIBTrainer(_model(), get_dataset("boolean_circuit"), TrainConfig(**SETTINGS),
                         device="cpu")
    ckpt = DIBCheckpointer(str(tmp_path / "ckpt"))
    writer = EventWriter(str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="diverged again at epoch 3"):
            trainer.fit(torch.Generator().manual_seed(0), hook_every=1,
                        hooks=[poison_at_2, CheckpointHook(ckpt)], telemetry=writer)
    writer.close()
    events = list(read_events(str(tmp_path)))
    assert [e["mtype"] for e in events if e["type"] == "mitigation"] == \
        ["divergence_rollback"] * 3
    assert len([e for e in events if e["type"] == "quarantine"]) == 2


def test_without_a_checkpoint_the_guard_warns_once(tmp_path):
    trainer = DIBTrainer(_model(), get_dataset("boolean_circuit"), TrainConfig(**SETTINGS),
                         device="cpu")
    writer = EventWriter(str(tmp_path))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, history = trainer.fit(torch.Generator().manual_seed(0), hook_every=1,
                                 telemetry=writer, fault_plan=FaultPlan.parse("nan@chunk2"))
    writer.close()
    assert len(caught) == 1 and "no checkpoint to roll back to" in str(caught[0].message)
    assert not np.isfinite(history.loss[-1])
    mitigations = [e for e in read_events(str(tmp_path)) if e["type"] == "mitigation"]
    assert [(m["mtype"], m["action"]) for m in mitigations] == [("divergence_detected", "none")]


# ------------------------------------------------------------- the sweep
# Members 0 and 1 poisoned at the second boundary; every restore poisons
# member 1 again: member 0 is healed, member 1 ejected, member 2 untouched.
SWEEP_PLAN = "replica_nan@chunk2:0,replica_nan@chunk2:1"


def _jax_sweep_fit(tmp, model):
    jax_bundle = jax_get_dataset("boolean_circuit")
    sweep = JaxSweep(JaxDIB(feature_dimensionalities=tuple(jax_bundle.feature_dimensionalities),
                            **DIB), jax_bundle, JaxTrainConfig(**SETTINGS),
                     SETTINGS["beta_start"], ENDS)
    sweep.init = jax.jit(sweep.init)     # the restore's template: one compile, not per op
    init = {"model": interop.params_to_flax(model)}
    states = JaxTrainState(init, jax.vmap(sweep.base.optimizer.init)(init),
                           jnp.zeros(3, jnp.int32))
    histories = jax.vmap(lambda _: jax_history_init(EPOCHS, 10))(jnp.arange(3))
    writer = JaxWriter(str(tmp), process_index=0)
    ckpt = JaxPoisonedRestore(JaxCheckpointer(str(tmp / "ckpt")), 1, telemetry=writer)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, records = sweep.fit(jax.random.split(jax.random.key(12), 3), hook_every=1,
                               states=states, histories=histories,
                               hooks=[JaxCheckpointHook(ckpt)], telemetry=writer,
                               fault_plan=JaxFaultPlan.parse(SWEEP_PLAN))
    writer.close()
    return sweep, records, list(jax_read_events(str(tmp)))


def _port_sweep_fit(tmp, plan):
    sweep = BetaSweepTrainer(_model(replicas=3), get_dataset("boolean_circuit"),
                             TrainConfig(**SETTINGS), SETTINGS["beta_start"], ENDS,
                             device="cpu")
    writer = EventWriter(str(tmp))
    ckpt = DIBCheckpointer(str(tmp / "ckpt"))
    if plan:
        ckpt = PoisonedReplicaRestore(ckpt, 1, telemetry=writer)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        states, records = sweep.fit([torch.Generator().manual_seed(member_seed(0, r))
                                     for r in range(3)], hook_every=1,
                                    hooks=[CheckpointHook(ckpt)], telemetry=writer,
                                    fault_plan=FaultPlan.parse(plan) if plan else None)
    writer.close()
    return sweep, states, records, list(read_events(str(tmp)))


@pytest.fixture(scope="module")
def quarantine(tmp_path_factory):
    root = tmp_path_factory.mktemp("quarantine")
    for name in ("jax", "clean", "port"):
        (root / name).mkdir()
    return dict(jax=_jax_sweep_fit(root / "jax", _model(replicas=3)),
                clean=_port_sweep_fit(root / "clean", None),
                port=_port_sweep_fit(root / "port", SWEEP_PLAN))


def _incidents(events):
    return [(e["type"], e.get("mtype") or e.get("kind"), e.get("replica"), e.get("epoch"),
             sorted(k for k in e if k not in ("t", "mono", "seq", "run", "proc", "v")))
            for e in events if e["type"] in ("fault", "mitigation")]


def test_the_sweep_heals_and_ejects_the_members_the_jax_sweep_does(quarantine):
    jax_sweep, jax_records, jax_events = quarantine["jax"]
    sweep, _, records, events = quarantine["port"]
    assert _incidents(events) == _incidents(jax_events)
    assert [(e["mtype"], e["replica"]) for e in events if e["type"] == "mitigation"] == \
        [("divergence_rollback", 0), ("replica_ejected", 1)]
    assert [r.ejected for r in records] == [r.ejected for r in jax_records] == \
        [False, True, False]
    assert sweep.ejected_replicas.keys() == jax_sweep.ejected_replicas.keys() == {1}
    assert sweep.ejected_replicas[1]["reason"] == jax_sweep.ejected_replicas[1]["reason"]
    for event in events:
        assert validate_event(event, JAX_SCHEMA) == [], event


def test_the_members_not_ejected_stay_bit_equal(quarantine):
    """The healed member 0 and the untouched member 2 equal the
    uninterrupted sweep bit for bit: records, weights and Adam's moments."""
    _, clean_states, clean_records, _ = quarantine["clean"]
    _, states, records, _ = quarantine["port"]
    model, clean_model = states.params["model"], clean_states.params["model"]
    for r in (0, 2):
        for name in HISTORY:
            assert np.array_equal(getattr(records[r], name), getattr(clean_records[r], name)), \
                (r, name)
    for (name, param), clean in zip(model.named_parameters(), clean_model.parameters()):
        pairs = [(param, clean)] + [(states.optimizer.state[param][slot],
                                     clean_states.optimizer.state[clean][slot])
                                    for slot in ("exp_avg", "exp_avg_sq")]
        for got, want in pairs:
            for r in (0, 2):
                assert torch.equal(model.member_values(name, got, r),
                                   model.member_values(name, want, r)), (name, r)
