"""The port's trainer, hooks, data and schedules vs the JAX package's.

The trainer test is an exact replay: both trainers start from the same
weights (the JAX ``fit`` resumes from them), and the port is fed the JAX key
schedule's batch indices and noise (fit key -> chunk keys -> epoch keys ->
step keys, ``randint`` in replacement mode, ``fold_in(key, 1)``
permutations in permutation mode, ``normal(k_noise, mus.shape)`` for the
encoders), so both runs take the same Adam steps. Parameters must agree per
leaf to 1e-5 of the leaf's norm and history rows to 1e-5 (float32 forward
and backward passes in another order; Adam normalises each step, so the
relative error does not grow over six steps). One leaf is held to a looser
bound: the attention's key bias, whose gradient is zero in exact arithmetic
(softmax ignores a shift shared by a query's scores). Both runs move it by
Adam-normalised rounding noise only, so each must stay within 2 x the summed
learning rates of zero. The MI hook agrees to 1e-5 nats, the data exactly.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.models.per_particle import PerParticleDIBModel as JaxPerParticle
from dib_tpu.ops import schedules as jax_schedules
from dib_tpu.ops import similarity as jax_similarity
from dib_tpu.ops.gaussian import reparameterize as jax_reparameterize
from dib_tpu.train import losses as jax_losses
from dib_tpu.train.history import HistoryRecord as JaxHistoryRecord
from dib_tpu.train.history import history_init as jax_history_init
from dib_tpu.train.hooks import InfoPerFeatureHook as JaxInfoHook
from dib_tpu.train.loop import DIBTrainer as JaxTrainer
from dib_tpu.train.loop import TrainConfig as JaxTrainConfig
from dib_tpu.train.loop import TrainState as JaxTrainState
from dib_tpu.workloads.amorphous import AmorphousWorkloadConfig as JaxAmorphousConfig
from dib_tpu_torch import interop
from dib_tpu_torch.data import DatasetBundle, get_dataset
from dib_tpu_torch.models import DistributedIBModel, PerParticleDIBModel
from dib_tpu_torch.ops import schedules, similarity
from dib_tpu_torch.train import (
    DIBTrainer,
    Every,
    GeneratorDraws,
    InfoPerFeatureHook,
    TrainConfig,
    history_extend,
    make_optimizer,
    history_init,
    history_record,
    losses,
)
from dib_tpu_torch.train.history import HistoryRecord
from dib_tpu_torch.workloads import AmorphousWorkloadConfig, build_model

torch.set_num_threads(1)

TOL = 1e-5
PARTICLES = dict(num_particles=8, encoder_hidden=(8,), embedding_dim=4, num_blocks=2,
                 num_heads=2, key_dim=8, ff_hidden=(8,), head_hidden=(8,))
DIB = dict(encoder_hidden=(8,), integration_hidden=(8,), output_dim=1, embedding_dim=4)
HISTORY = ("beta", "kl_per_feature", "loss", "val_loss", "metric", "val_metric")


@pytest.fixture(scope="module")
def particles_bundle():
    return get_dataset("amorphous_particles", number_particles_to_use=8,
                       num_synthetic_neighborhoods=64)


def _models(kind, bundle):
    """(JAX model, port model) of one tiny configuration."""
    if kind == "per_particle":
        return (JaxPerParticle(**PARTICLES),
                PerParticleDIBModel(**PARTICLES, device="cpu",
                                    generator=torch.Generator().manual_seed(0)))
    dims = tuple(bundle.feature_dimensionalities)
    return (JaxDIB(feature_dimensionalities=dims, **DIB),
            DistributedIBModel(dims, **DIB, device="cpu",
                               generator=torch.Generator().manual_seed(0)))


class JaxKeyReplay:
    """The draws of ``dib_tpu`` ``DIBTrainer.fit(key, hook_every=...,
    state=..., history=...)`` (a resumed fit splits no init key)."""

    def __init__(self, key, num_epochs, hook_every):
        self.epoch_keys, done = [], 0
        while done < num_epochs:
            this = min(hook_every or num_epochs, num_epochs - done)
            key, k_chunk = jax.random.split(key)
            self.epoch_keys += list(jax.random.split(k_chunk, this))
            done += this

    def start_epoch(self, n, steps, batch_size, sampling):
        epoch_key = self.epoch_keys.pop(0)
        keys = jax.random.split(epoch_key, steps + 1)
        self.val_key = keys[-1]
        pairs = [jax.random.split(k) for k in keys[:-1]]
        self.noise_keys = [p[1] for p in pairs]
        if sampling == "replacement":
            idx = [jax.random.randint(p[0], (batch_size,), 0, n) for p in pairs]
        else:
            k_perm = jax.random.fold_in(epoch_key, 1)
            perms = [jax.random.permutation(jax.random.fold_in(k_perm, i), n)
                     for i in range(-(-steps * batch_size // n))]
            idx = jnp.concatenate(perms)[:steps * batch_size].reshape(steps, batch_size)
        return torch.from_numpy(np.array(jnp.stack(list(idx)))).long()

    def step_noise(self, step, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.noise_keys[step], shape)))

    def val_noise(self, chunk, num_chunks, shape):
        assert num_chunks == 1                      # supervised: one validation forward
        return torch.from_numpy(np.array(jax.random.normal(self.val_key, shape)))


@pytest.mark.parametrize("kind,sampling", [
    ("per_particle", "replacement"),
    ("per_particle", "permutation"),
    ("dib", "replacement"),            # the sampling modes are the trainer's, not the model's
])
def test_trainer_replays_the_jax_trainer(particles_bundle, kind, sampling):
    bundle = particles_bundle if kind == "per_particle" else get_dataset("boolean_circuit")
    jax_bundle = (jax_get_dataset("amorphous_particles", number_particles_to_use=8,
                                  num_synthetic_neighborhoods=64)
                  if kind == "per_particle" else jax_get_dataset("boolean_circuit"))
    jax_model, model = _models(kind, bundle)
    settings = dict(learning_rate=1e-3, batch_size=4 if kind == "per_particle" else 8,
                    beta_start=1e-3, beta_end=1e-1, num_pretraining_epochs=0,
                    num_annealing_epochs=2, steps_per_epoch=3, warmup_steps=2,
                    max_val_points=64, batch_sampling=sampling)
    jax_trainer = JaxTrainer(jax_model, jax_bundle, JaxTrainConfig(**settings))
    init = {"model": interop.params_to_flax(model)}
    jax_state = JaxTrainState(init, jax_trainer.optimizer.init(init), jnp.zeros((), jnp.int32))
    key = jax.random.key(11)
    jax_state, jax_history = jax_trainer.fit(
        key, hook_every=1, state=jax_state,
        history=jax_history_init(2, jax_bundle.number_features))

    trainer = DIBTrainer(model, bundle, TrainConfig(**settings), device="cpu")
    epochs = []
    state, history = trainer.fit(
        draws=JaxKeyReplay(key, 2, 1), hook_every=1,
        hooks=[lambda tr, st, epoch: epochs.append(epoch)])
    assert epochs == [1, 2] and state.epoch == 2
    assert state.schedule.get_last_lr() == [1e-3]

    want = jax.tree_util.tree_leaves_with_path(jax.device_get(jax_state.params["model"]))
    got = dict(jax.tree_util.tree_leaves_with_path(interop.params_to_flax(model)))
    assert len(got) == len(want)
    summed_lr = 1e-3 * (0 + 0.5 + 4)               # updates 0..5 under the warmup
    for path, w in want:
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            assert max(np.abs(got[path]).max(), np.abs(w).max()) <= 2 * summed_lr, name
            continue
        err = np.linalg.norm(got[path] - w)
        assert err <= TOL * np.linalg.norm(w) + 1e-8, (name, err)
    for name in HISTORY:
        np.testing.assert_allclose(getattr(history, name), getattr(jax_history, name),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_preemption_stops_where_the_jax_fit_stops():
    """Both fits check for a pending preemption before each chunk: a notice
    pending before the first chunk stops both at epoch 0 before any
    training (the JAX fit raises before it compiles a chunk); in the port,
    one that arrives at a chunk boundary stops the fit there, and one that
    arrives after the last chunk lets it complete, as the JAX loop, which
    checks nowhere else, does."""
    from dib_tpu.train.preempt import PreemptionGuard as JaxGuard
    from dib_tpu.train.preempt import TrainingPreempted as JaxPreempted
    from dib_tpu_torch.train.preempt import PreemptionGuard, TrainingPreempted

    bundle = get_dataset("boolean_circuit")
    settings = dict(batch_size=8, num_pretraining_epochs=1, num_annealing_epochs=2,
                    steps_per_epoch=1, max_val_points=64)

    def stop_epoch(fit, guard_type, preempted_type, notice_at):
        with guard_type(grace_s=600.0) as guard:
            if notice_at is None:
                guard.request()

            def notice(trainer, state, epoch):
                if epoch == notice_at:
                    guard.request()

            try:
                fit(guard, notice)
            except preempted_type as exc:
                return exc.epoch
        return "completed"

    jax_bundle = jax_get_dataset("boolean_circuit")
    jax_model, model = _models("dib", bundle)
    jax_trainer = JaxTrainer(jax_model, jax_bundle, JaxTrainConfig(**settings))
    init = {"model": interop.params_to_flax(model)}
    jax_state = JaxTrainState(init, jax_trainer.optimizer.init(init), jnp.zeros((), jnp.int32))
    stops = [stop_epoch(lambda guard, hook: jax_trainer.fit(
        jax.random.key(0), hooks=[hook], hook_every=1, state=jax_state,
        history=jax_history_init(3, jax_bundle.number_features), preempt=guard),
        JaxGuard, JaxPreempted, None)]
    for notice_at in (None, 1, 3):
        trainer = DIBTrainer(_models("dib", bundle)[1], bundle, TrainConfig(**settings),
                             device="cpu")
        stops.append(stop_epoch(lambda guard, hook: trainer.fit(
            torch.Generator().manual_seed(0), hooks=[hook], hook_every=1, preempt=guard),
            PreemptionGuard, TrainingPreempted, notice_at))
    assert stops == [0, 0, 1, "completed"]


def test_adam_with_warmup_matches_optax():
    """``make_optimizer`` is ``optax.adam`` under ``optax.linear_schedule(0,
    lr, warmup)``: the first update uses a learning rate of 0."""
    rng = np.random.default_rng(12)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    config = TrainConfig(learning_rate=1e-2, warmup_steps=3)
    weight = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer, schedule = make_optimizer(config, [weight])
    tx = optax.adam(optax.linear_schedule(0.0, config.learning_rate, config.warmup_steps))
    want = jnp.asarray(w0)
    opt_state = tx.init(want)
    for update in range(6):
        grad = rng.standard_normal(w0.shape).astype(np.float32)
        weight.grad = torch.from_numpy(grad)
        optimizer.step()
        schedule.step()
        updates, opt_state = tx.update(jnp.asarray(grad), opt_state, want)
        want = optax.apply_updates(want, updates)
        if update == 0:
            np.testing.assert_array_equal(weight.detach().numpy(), w0)
        np.testing.assert_allclose(weight.detach().numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_info_hook_replays_the_jax_hook(particles_bundle):
    """Two invocations of the hook (the JAX hook splits its key per call) on
    the per-particle model, every particle channel at once."""
    jax_model, model = _models("per_particle", particles_bundle)
    params = interop.params_to_flax(model)
    jax_hook = JaxInfoHook(64, 2, seed=3)
    jax_view = types.SimpleNamespace(model=jax_model, bundle=particles_bundle)
    jax_state = types.SimpleNamespace(params={"model": params})
    for epoch in (5, 10):
        jax_hook(jax_view, jax_state, epoch)

    hook_key = [jax.random.key(3)]

    def replay(port_model, rows):
        hook_key[0], k = jax.random.split(hook_key[0])
        rows = jnp.asarray(rows.numpy())
        idx, us = [], []
        for kb in jax.random.split(k, 2):
            k_idx, k_mi = jax.random.split(kb)
            batch_idx = jax.random.randint(k_idx, (64,), 0, rows.shape[0])
            mus, logvars = jax_model.encode(params, rows[batch_idx])
            keys = jax.random.split(k_mi, mus.shape[0])
            idx.append(np.asarray(batch_idx))
            us.append(np.asarray(jax.vmap(jax_reparameterize)(keys, mus, logvars)))
        return torch.from_numpy(np.stack(idx)), torch.from_numpy(np.stack(us))

    hook = Every(5, InfoPerFeatureHook(64, 2, draws=replay))
    trainer = types.SimpleNamespace(model=model, bundle=particles_bundle)
    for epoch in (3, 5, 7, 10):
        hook(trainer, None, epoch)
    assert list(hook.hook.epochs) == [5, 10]
    got, want = hook.hook.bounds_bits, jax_hook.bounds_bits
    assert got.shape == want.shape == (2, 8, 2)
    np.testing.assert_allclose(got * np.log(2.0), want * np.log(2.0), rtol=TOL, atol=TOL)
    assert (got[..., 0] <= got[..., 1] + TOL).all()


def test_amorphous_bundle_matches_jax():
    got = get_dataset("amorphous_particles", num_synthetic_neighborhoods=64, seed=4)
    want = jax_get_dataset("amorphous_particles", num_synthetic_neighborhoods=64, seed=4)
    for name in ("x_train", "y_train", "x_valid", "y_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert list(got.feature_dimensionalities) == list(want.feature_dimensionalities) == [12] * 50
    assert got.extras["source"] == "synthetic" and got.x_valid.shape == (9, 600)
    np.testing.assert_array_equal(got.extras["sets_train"], want.extras["sets_train"])


def test_real_glass_export_loads_as_jax_loads_it(tmp_path):
    """A ``{protocol}.npz`` export (ragged object arrays per split) is read
    as the JAX package reads it, and takes the place of the synthetic data."""
    rng = np.random.default_rng(5)
    export = {}
    for split, n in (("train", 6), ("val", 3)):
        sizes = rng.integers(8, 14, size=n)
        for name, shape in (("particle_positions", 2), ("types", 0)):
            ragged = np.empty(n, dtype=object)
            ragged[:] = [(rng.normal(0, 3, (k, 2)) if shape else rng.integers(1, 3, k))
                         .astype(np.float32) for k in sizes]
            export[f"{split}_{name}"] = ragged
        export[f"{split}_is_loci"] = (rng.random((n, 1)) < 0.5).astype(np.float32)
    np.savez(os.path.join(tmp_path, "Quench.npz"), **export)
    kwargs = dict(data_path=str(tmp_path), protocol="Quench", number_particles_to_use=10)
    got, want = get_dataset("amorphous_particles", **kwargs), jax_get_dataset(
        "amorphous_particles", **kwargs)
    assert got.extras["source"] == want.extras["source"] == "real"
    for name in ("x_train", "y_train", "x_valid", "y_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.x_train.shape == (6, 120) and got.x_valid.shape == (3, 120)


def test_contrastive_trainer_validates_in_training_sized_chunks():
    """InfoNCE: the prediction is matched against ``y_encoder(y)``, and the
    validation rows are cut to whole training-sized chunks, one noise draw each."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    y = (x @ rng.standard_normal((3, 2))).astype(np.float32)
    bundle = DatasetBundle(x_train=x, y_train=y, x_valid=x[:21], y_valid=y[:21],
                           feature_dimensionalities=[1, 2], output_dimensionality=4,
                           loss="infonce", loss_is_info_based=True)
    model = DistributedIBModel((1, 2), encoder_hidden=(8,), integration_hidden=(8,),
                               output_dim=4, embedding_dim=3, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    config = TrainConfig(batch_size=8, steps_per_epoch=2, num_pretraining_epochs=1,
                         num_annealing_epochs=1, max_val_points=21)

    class Counting(GeneratorDraws):
        chunks = []

        def val_noise(self, chunk, num_chunks, shape):
            self.chunks.append((chunk, num_chunks, tuple(shape)))
            return super().val_noise(chunk, num_chunks, shape)

    with pytest.raises(ValueError, match="y_encoder"):
        DIBTrainer(model, bundle, config, device="cpu")
    trainer = DIBTrainer(model, bundle, config, y_encoder=torch.nn.Linear(2, 4), device="cpu")
    _, history = trainer.fit(draws=Counting(torch.Generator().manual_seed(1)))
    assert Counting.chunks == [(0, 2, (2, 8, 3)), (1, 2, (2, 8, 3))] * 2
    assert np.isfinite(history.loss).all() and np.isfinite(history.val_loss).all()
    assert (history.metric == 0).all() and (history.val_metric == 0).all()


def test_workload_config_matches_jax():
    got, want = AmorphousWorkloadConfig(), JaxAmorphousConfig()
    for steps in (1, 10):
        assert dataclasses.asdict(got.train_config(steps)) == {
            k: v for k, v in dataclasses.asdict(want.train_config(steps)).items()
            if k != "prefetch_epochs"}
    model = build_model(got, device="cpu", use_flash=True, **{
        k: v for k, v in PARTICLES.items() if k != "num_particles"})
    assert model.num_particles == 50 and model.aggregator.blocks[0].attention.use_flash


def test_log_annealed_beta_matches_jax():
    steps = np.arange(-3, 40)
    for args in ((2e-6, 2e-1, 25, 3), (10.0, 1e-4, 30, 0)):
        for clip in (True, False):
            want = jax_schedules.log_annealed_beta(jnp.asarray(steps), *args, clip_progress=clip)
            got = schedules.log_annealed_beta(torch.from_numpy(steps), *args,
                                              clip_progress=clip)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(schedules.log_annealed_beta(0, 2e-6, 2e-1, 25)) == np.float32(2e-6)
    np.testing.assert_allclose(schedules.beta_grid(1e-4, 3.0, 7).numpy(),
                               np.asarray(jax_schedules.beta_grid(1e-4, 3.0, 7)), rtol=1e-6)
    np.testing.assert_allclose(schedules.linear_warmup(torch.arange(8), 0.5, 4).numpy(),
                               np.asarray(jax_schedules.linear_warmup(jnp.arange(8), 0.5, 4)))


def test_history_and_to_bits_match_jax():
    history = history_init(4, 3)
    for t in range(3):
        history = history_record(history, {"beta": 0.1 * t, "kl_per_feature": torch.arange(3.0),
                                           "loss": 1.0 + t, "val_loss": 2.0, "metric": 0.5,
                                           "val_metric": 0.25})
    history = history_extend(history, 2)
    record = HistoryRecord.from_device(history)
    assert record.kl_per_feature.shape == (3, 3) and history["beta"].shape == (6,)
    want = JaxHistoryRecord(**{name: getattr(record, name) for name in HISTORY})
    for info in (True, False):
        got, w = record.to_bits(info), want.to_bits(info)
        for name in HISTORY:
            np.testing.assert_array_equal(getattr(got, name), getattr(w, name))
    np.testing.assert_allclose(record.combined_loss, want.combined_loss)


def test_losses_and_similarity_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((16, 1)).astype(np.float32)
    labels = (rng.random((16, 1)) < 0.5).astype(np.float32)
    multi = rng.standard_normal((16, 5)).astype(np.float32)
    classes = rng.integers(0, 5, size=16).astype(np.float32)
    t = torch.from_numpy
    cases = [
        (losses.bce_with_logits(t(logits), t(labels)), jax_losses.bce_with_logits(logits, labels)),
        (losses.sparse_ce_with_logits(t(multi), t(classes)),
         jax_losses.sparse_ce_with_logits(multi, classes)),
        (losses.mse(t(multi), t(multi[::-1].copy())), jax_losses.mse(multi, multi[::-1])),
        (losses.binary_accuracy(t(logits), t(labels)), jax_losses.binary_accuracy(logits, labels)),
        (losses.multiclass_accuracy(t(multi), t(classes)),
         jax_losses.multiclass_accuracy(multi, classes)),
    ]
    a, b = multi[:8], multi[8:]
    for kind in ("l2sq", "l2", "l1", "linf", "cosine"):
        cases.append((similarity.scaled_similarity(t(a), t(b), kind, 0.5),
                      jax_similarity.scaled_similarity(a, b, kind, 0.5)))
    cases.append((similarity.symmetric_infonce(t(a), t(b), "l2", 2.0, halved=True),
                  jax_similarity.symmetric_infonce(a, b, "l2", 2.0, halved=True)))
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="infonce"):
        losses.resolve_loss("infonce")


def test_generator_draws_cover_each_row_once_per_pass():
    draws = GeneratorDraws(torch.Generator().manual_seed(0))
    idx = draws.start_epoch(10, 3, 4, "permutation")
    assert idx.shape == (3, 4)
    assert sorted(idx.flatten()[:10].tolist()) == list(range(10))
    rows = draws.start_epoch(10, 3, 4, "replacement")
    assert rows.shape == (3, 4) and 0 <= int(rows.min()) and int(rows.max()) < 10


def test_trainer_refuses_to_fall_back(monkeypatch, particles_bundle):
    _, model = _models("per_particle", particles_bundle)
    config = TrainConfig(batch_size=4, steps_per_epoch=1, num_pretraining_epochs=0,
                         num_annealing_epochs=1)
    trainer = DIBTrainer(model, particles_bundle, config, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        trainer.fit()
    with pytest.raises(ValueError, match="batch_sampling"):
        DIBTrainer(model, particles_bundle, dataclasses.replace(config, batch_sampling="x"),
                   device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DIBTrainer(model, particles_bundle, config)
    adam, schedule = make_optimizer(config, model.parameters())
    assert isinstance(adam, torch.optim.Adam) and schedule.get_last_lr() == [config.learning_rate]
    sgd, _ = make_optimizer(dataclasses.replace(config, optimizer="sgd"), model.parameters())
    assert isinstance(sgd, torch.optim.SGD)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(dataclasses.replace(config, optimizer="rmsprop"), model.parameters())
