"""The port's beta sweep against the JAX package's, and the rules it keeps.

A port sweep of three endpoints replays ``dib_tpu``'s ``BetaSweepTrainer``
(vmap engine, no mesh): both start from the same stacked weights (the JAX
fit resumes from them through the stacked interop) and each port replica is
fed its JAX key chain (``JaxKeyReplay`` of the replica's key), so both take
the same Adam steps. Parameters agree per leaf and replica to 1e-5 of the
leaf's norm, with the attention key-bias exception of
``test_torch_train.py`` (its gradient is zero in exact arithmetic), and
history rows to 1e-5. The sweep's MI hook replays the JAX hook's key chain
to 1e-5 nats, with one ``mi_row_stats`` call per evaluation batch over all
R x P channels, on a resumed run too. The stacked forward equals R serial
models to 1e-6, and a sweep of one replica a serial ``DIBTrainer`` on the
same draws to 1e-5. The same holds for ``DistributedIBModel(replicas=R)``,
the boolean model of the CLI's sweep: its stacked forward against R serial
models, and a sweep of three replicas against the JAX sweep on the boolean
circuit.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.models.per_particle import PerParticleDIBModel as JaxPerParticle
from dib_tpu.parallel.sweep import BetaSweepTrainer as JaxSweep
from dib_tpu.parallel.sweep_hooks import SweepInfoPerFeatureHook as JaxSweepHook
from dib_tpu.train.history import history_init as jax_history_init
from dib_tpu.train.loop import TrainConfig as JaxTrainConfig
from dib_tpu.train.loop import TrainState as JaxTrainState
from dib_tpu_torch import interop
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.models import DistributedIBModel, PerParticleDIBModel
from dib_tpu_torch.ops import info_bounds
from dib_tpu_torch.ops.schedules import log_annealed_beta
from dib_tpu_torch.parallel import (
    BetaSweepTrainer,
    PerReplicaHook,
    SweepInfoPerFeatureHook,
    member_seed,
)
from dib_tpu_torch.train import DIBTrainer, TrainConfig
from dib_tpu_torch.workloads import AmorphousWorkloadConfig, run_amorphous_sweep
from test_torch_train import HISTORY, PARTICLES, JaxKeyReplay

torch.set_num_threads(1)

TOL = 1e-5
ENDS = (1e-2, 1e-1, 1.0)
R, P, D = len(ENDS), PARTICLES["num_particles"], PARTICLES["embedding_dim"]
SETTINGS = dict(learning_rate=1e-3, batch_size=4, beta_start=1e-3, beta_end=1e-1,
                num_pretraining_epochs=0, num_annealing_epochs=2, steps_per_epoch=3,
                warmup_steps=2, max_val_points=64)
SEEDS = [member_seed(0, r) for r in range(R)]
HOOK_BATCH, HOOK_BATCHES, HOOK_SEED = 16, 2, 3
SUMMED_LR = 1e-3 * (0 + 0.5 + 4)          # updates 0..5 under the warmup


def _stacked(seeds=SEEDS, **overrides):
    return PerParticleDIBModel(**PARTICLES, device="cpu", replicas=len(seeds),
                               generator=[torch.Generator().manual_seed(s) for s in seeds],
                               **overrides)


def _serial(seed, **overrides):
    return PerParticleDIBModel(**PARTICLES, device="cpu",
                               generator=torch.Generator().manual_seed(seed), **overrides)


def _generators(seeds=SEEDS):
    return [torch.Generator().manual_seed(s) for s in seeds]


def _hold_params(got: dict, want: dict, member=None):
    """Two state dicts, per leaf: 1e-5 of the leaf's norm; the key bias
    (zero gradient in exact arithmetic) within 2 x the summed learning
    rates."""
    assert got.keys() == want.keys()
    for name, w in want.items():
        g, w = got[name].detach().numpy(), w.detach().numpy()
        if name.endswith("attention.key.bias"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 2 * SUMMED_LR, (name, member)
            continue
        err = np.linalg.norm(g - w)
        assert err <= TOL * np.linalg.norm(w) + 1e-8, (name, member, err)


class JaxHookReplay:
    """The draws of ``dib_tpu``'s ``SweepInfoPerFeatureHook(seed=...)``: the
    n-th call's key from its split chain (``_key_for_call``), split over
    replicas, then per replica ``all_features_bounds_kernel``'s batch
    indices and per-channel noise. u is formed from the port model's
    channel parameters."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)

    def __call__(self, model, rows, call):
        k = self.key
        for _ in range(call + 1):
            k, k_call = jax.random.split(k)
        idx, eps = [], []
        for k_replica in jax.random.split(k_call, R):
            idx_r, eps_r = [], []
            for kb in jax.random.split(k_replica, HOOK_BATCHES):
                k_idx, k_mi = jax.random.split(kb)
                idx_r.append(np.asarray(jax.random.randint(k_idx, (HOOK_BATCH,), 0,
                                                           rows.shape[0])))
                eps_r.append(np.stack([np.asarray(jax.random.normal(k, (HOOK_BATCH, D)))
                                       for k in jax.random.split(k_mi, P)]))
            idx.append(idx_r)
            eps.append(eps_r)
        idx = torch.from_numpy(np.asarray(idx).transpose(1, 0, 2)).long()    # [b, R, B]
        eps = torch.from_numpy(np.asarray(eps).transpose(1, 0, 2, 3, 4))    # [b, R, P, B, d]
        with torch.no_grad():
            u = []
            for b in range(HOOK_BATCHES):
                mus, logvars = model.encode(rows[idx[b]])
                u.append(mus + eps[b] * torch.exp(0.5 * logvars))
        return idx, torch.stack(u)


@pytest.fixture(scope="module")
def bundle():
    return get_dataset("amorphous_particles", number_particles_to_use=P,
                       num_synthetic_neighborhoods=64)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX vmap sweep of 3 replicas x 2 epochs x 3 steps, resumed from the
    port's stacked initial weights, with its MI hook after each epoch."""
    init = {"model": interop.params_to_flax(_stacked())}
    jax_bundle = jax_get_dataset("amorphous_particles", number_particles_to_use=P,
                                 num_synthetic_neighborhoods=64)
    sweep = JaxSweep(JaxPerParticle(**PARTICLES), jax_bundle, JaxTrainConfig(**SETTINGS),
                     SETTINGS["beta_start"], ENDS)
    states = JaxTrainState(init, jax.vmap(sweep.base.optimizer.init)(init),
                           jnp.zeros(R, jnp.int32))
    histories = jax.vmap(lambda _: jax_history_init(2, P))(jnp.arange(R))
    keys = jax.random.split(jax.random.key(11), R)
    hook = JaxSweepHook(HOOK_BATCH, HOOK_BATCHES, seed=HOOK_SEED)
    states, records = sweep.fit(keys, hook_every=1, states=states, histories=histories,
                                hooks=[hook])
    return dict(keys=keys, params=jax.device_get(states.params["model"]), records=records,
                hook=hook)


@pytest.fixture(scope="module")
def port_run(bundle, jax_run):
    """The port sweep fed the JAX run's draws, counting the group axis of
    every ``mi_row_stats`` call."""
    model = _stacked()
    sweep = BetaSweepTrainer(model, bundle, TrainConfig(**SETTINGS), SETTINGS["beta_start"],
                             ENDS, device="cpu")
    hook = SweepInfoPerFeatureHook(HOOK_BATCH, HOOK_BATCHES, draws=JaxHookReplay(HOOK_SEED))
    groups = []
    real = info_bounds.mi_row_stats

    def counting(u, mus, logvars, diagonal=True):
        groups.append(u.shape[0])
        return real(u, mus, logvars, diagonal)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(info_bounds, "mi_row_stats", counting)
        states, records = sweep.fit(
            draws=[JaxKeyReplay(jax_run["keys"][r], 2, 1) for r in range(R)],
            hook_every=1, hooks=[hook])
    return dict(model=model, states=states, records=records, hook=hook, groups=groups)


@pytest.mark.parametrize("use_flash,fuse_qkv", [(False, False), (True, False), (True, True)])
def test_stacked_forward_equals_serial_models(use_flash, fuse_qkv):
    """(a) Replica r of a model built from R generators holds the weights of
    the serial model from the r-th, and computes what it computes."""
    stacked = _stacked(use_flash=use_flash, fuse_qkv=fuse_qkv)
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((R, 5, P * 12)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((R, 5, P, D)).astype(np.float32))
    prediction, aux = stacked(x, eps=eps)
    assert stacked.noise_shape(5) == (R, 5, P, D) and prediction.shape == (R, 5, 1)
    mus, logvars = stacked.encode(x)
    for r, seed in enumerate(SEEDS):
        serial = _serial(seed, use_flash=use_flash, fuse_qkv=fuse_qkv)
        carved = stacked.carve(r)
        for name, value in serial.state_dict().items():
            assert torch.equal(stacked.state_dict()[name][r], value), name
            assert torch.equal(carved.state_dict()[name], value), name
        want, want_aux = serial(x[r], eps=eps[r])
        torch.testing.assert_close(prediction[r], want, rtol=1e-6, atol=1e-6)
        for key in ("kl_per_feature", "mus", "logvars", "embeddings"):
            torch.testing.assert_close(aux[key][r], want_aux[key], rtol=1e-6, atol=1e-6)
        for got, w in zip((mus[r], logvars[r]), serial.encode(x[r])):
            torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)
    pair = stacked.carve([2, 0])
    assert pair.replicas == 2
    assert torch.equal(pair.state_dict()["aggregator.head.layers.0.kernel"][0],
                       stacked.state_dict()["aggregator.head.layers.0.kernel"][2])


def test_sweep_replays_the_jax_sweep(jax_run, port_run):
    """(b) Every replica's parameters and history rows against the JAX vmap sweep."""
    want = interop.params_from_flax(jax_run["params"])
    got = port_run["model"].state_dict()
    for r in range(R):
        _hold_params({k: v[r] for k, v in got.items()}, {k: v[r] for k, v in want.items()}, r)
    assert port_run["states"].epoch == 2 and len(port_run["records"]) == R
    for got, want in zip(port_run["records"], jax_run["records"]):
        for name in HISTORY:
            np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                       rtol=TOL, atol=TOL, err_msg=name)


def test_sweep_hook_replays_the_jax_hook(jax_run, port_run):
    """(d) Two calls: [R, P, 2] nats against the JAX hook's key chain, one
    ``mi_row_stats`` call per evaluation batch with G = R x P."""
    hook, want = port_run["hook"], jax_run["hook"]
    assert list(hook.epochs) == list(want.epochs) == [1, 2]
    for got, w in zip(hook.records, want.records):
        assert got["bounds"].shape == (R, P, 2)
        np.testing.assert_allclose(got["bounds"], w["bounds"], rtol=TOL, atol=TOL)
    assert port_run["groups"] == [R * P] * (2 * HOOK_BATCHES)
    for r in range(R):
        view = hook.replica_view(r)
        np.testing.assert_array_equal(
            view.bounds_bits, np.stack([rec["bounds"][r] for rec in hook.records]) / np.log(2.0))
        assert list(view.epochs) == [1, 2]


def test_one_replica_sweep_equals_the_serial_trainer(bundle):
    """(c) R = 1 against ``DIBTrainer`` on the same weights and draws; and a
    member carved out of a sweep by ``recover_replica`` continues as it
    would have inside it."""
    config = TrainConfig(**SETTINGS)
    sweep = BetaSweepTrainer(_stacked(SEEDS[:1]), bundle, config, config.beta_start,
                             ENDS[0], device="cpu")
    states, (record,) = sweep.fit(_generators(SEEDS[:1]), hook_every=1)
    serial = _serial(SEEDS[0])
    trainer = DIBTrainer(serial, bundle, dataclasses.replace(config, beta_end=ENDS[0]),
                         device="cpu")
    _, history = trainer.fit(torch.Generator().manual_seed(SEEDS[0]), hook_every=1)
    _hold_params(states.params["model"].carve(0).state_dict(), serial.state_dict())
    for name in HISTORY:
        np.testing.assert_allclose(getattr(record, name), getattr(history, name), rtol=TOL,
                                   atol=TOL, err_msg=name)

    full = BetaSweepTrainer(_stacked(), bundle, config, config.beta_start, ENDS, device="cpu")
    _, full_records = full.fit(_generators(), hook_every=1)
    part = BetaSweepTrainer(_stacked(), bundle, config, config.beta_start, ENDS, device="cpu")
    generators = _generators()
    states, _ = part.fit(generators, num_epochs=1)
    sub, state_1, history_1 = part.recover_replica(states, part.latest_history, 1)
    _, (recovered,) = sub.fit([generators[1]], num_epochs=1, states=state_1,
                              histories=history_1)
    for name in HISTORY:
        np.testing.assert_allclose(getattr(recovered, name), getattr(full_records[1], name),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_a_diverged_replica_leaves_the_others_alone(bundle):
    """(e) NaN weights in one replica: the others' parameters and history
    match a clean run, and one warning names the member and its endpoint.
    ``PerReplicaHook`` hands each replica's serial view to its own hook."""
    config = TrainConfig(**SETTINGS)
    runs = {}
    for poisoned in (False, True):
        model = _stacked()
        if poisoned:
            with torch.no_grad():
                model.aggregator.head.layers[0].kernel[1, 0, 0] = float("nan")
        sweep = BetaSweepTrainer(model, bundle, config, config.beta_start, ENDS, device="cpu")
        seen = []
        hook = PerReplicaHook(lambda r: (lambda trainer, state, epoch: seen.append(
            (r, epoch, trainer.config.beta_end, trainer.model.replicas,
             torch.isfinite(state.params["model"].aggregator.head.layers[0].kernel).all()
             .item()))))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, records = sweep.fit(_generators(), hooks=[hook], hook_every=1)
        runs[poisoned] = (model, records, seen, [str(w.message) for w in caught])
    (clean, clean_records, clean_seen, clean_messages), \
        (bad, bad_records, bad_seen, messages) = runs[False], runs[True]
    assert clean_messages == []
    assert len(messages) == 1 and "member(s) [1]" in messages[0] and "[0.1]" in messages[0]
    assert not np.isfinite(bad_records[1].loss).all()
    for r in (0, 2):
        for name, value in clean.state_dict().items():
            torch.testing.assert_close(bad.state_dict()[name][r], value[r], rtol=1e-6,
                                       atol=1e-6)
        for name in HISTORY:
            np.testing.assert_allclose(getattr(bad_records[r], name),
                                       getattr(clean_records[r], name), rtol=1e-6, atol=1e-6)
    assert [s[:4] for s in clean_seen] == [(r, e, ENDS[r], None) for e in (1, 2)
                                            for r in range(R)]
    assert [s[4] for s in bad_seen] == [True, False, True] * 2


def test_persist_reads_old_records_only_on_resume(tmp_path, bundle):
    """(f) A fresh hook ignores stale ``epoch*.npz`` files; ``resume=True``
    reads them, and a call drops those at or past its epoch."""
    stale = np.full((R, P, 2), 7.0)
    for epoch in (1, 5):
        np.savez(tmp_path / f"epoch{epoch}.npz", epoch=epoch, bounds=stale)
    sweep = BetaSweepTrainer(_stacked(), bundle, TrainConfig(**SETTINGS),
                             SETTINGS["beta_start"], ENDS, device="cpu")
    state, _ = sweep.init()
    fresh = SweepInfoPerFeatureHook(HOOK_BATCH, 1, persist=str(tmp_path))
    assert fresh.records == []
    fresh(sweep, state, 3)
    assert list(fresh.epochs) == [3]
    with np.load(tmp_path / "epoch3.npz") as data:
        np.testing.assert_array_equal(data["bounds"], fresh.records[0]["bounds"])
    resumed = SweepInfoPerFeatureHook(HOOK_BATCH, 1, persist=str(tmp_path), resume=True)
    assert list(resumed.epochs) == [1, 3, 5]
    resumed(sweep, state, 4)
    assert list(resumed.epochs) == [1, 3, 4]
    assert (resumed.records[0]["bounds"] == 7.0).all()


def test_resumed_sweep_hook_replays_the_jax_hook(tmp_path, bundle, jax_run, port_run):
    """(i) A hook resumed from its persisted records draws its next call by
    the call's index: replaying the JAX hook's key chain, its measurement at
    epoch 2 is the JAX hook's second call, to 1e-5 nats. With seeded draws,
    a resumed hook's measurement equals the uninterrupted hook's bit for
    bit, and differs from a fresh hook's first call."""
    sweep = BetaSweepTrainer(port_run["model"], bundle, TrainConfig(**SETTINGS),
                             SETTINGS["beta_start"], ENDS, device="cpu")
    states = port_run["states"]
    np.savez(tmp_path / "epoch1.npz", epoch=1, bounds=port_run["hook"].records[0]["bounds"])
    resumed = SweepInfoPerFeatureHook(HOOK_BATCH, HOOK_BATCHES, draws=JaxHookReplay(HOOK_SEED),
                                      persist=str(tmp_path), resume=True)
    resumed(sweep, states, 2)
    assert list(resumed.epochs) == [1, 2]
    np.testing.assert_allclose(resumed.records[1]["bounds"], jax_run["hook"].records[1]["bounds"],
                               rtol=TOL, atol=TOL)

    whole = SweepInfoPerFeatureHook(HOOK_BATCH, 1, seed=HOOK_SEED)
    first = SweepInfoPerFeatureHook(HOOK_BATCH, 1, seed=HOOK_SEED, persist=str(tmp_path / "p"))
    for epoch in (1, 2):
        whole(sweep, states, epoch)
    first(sweep, states, 1)
    again = SweepInfoPerFeatureHook(HOOK_BATCH, 1, seed=HOOK_SEED, persist=str(tmp_path / "p"),
                                    resume=True)
    again(sweep, states, 2)
    np.testing.assert_array_equal(again.records[1]["bounds"], whole.records[1]["bounds"])
    fresh = SweepInfoPerFeatureHook(HOOK_BATCH, 1, seed=HOOK_SEED)
    fresh(sweep, states, 2)
    assert not np.array_equal(fresh.records[0]["bounds"], whole.records[1]["bounds"])


def test_sweep_driver_follows_each_endpoint():
    """(g) A tiny ``run_amorphous_sweep`` on the CPU: one record per member,
    its beta row on its own endpoint's ramp."""
    config = AmorphousWorkloadConfig(num_steps=6, batch_size=4, number_particles=P,
                                     warmup_steps=2)
    hook = SweepInfoPerFeatureHook(HOOK_BATCH, 1)
    result = run_amorphous_sweep(
        0, config, beta_ends=(1e-2, 1e-1), num_repeats=2, steps_per_epoch=2,
        chunk_epochs=1, hooks=[hook], device="cpu", render=False,
        model_overrides={k: v for k, v in PARTICLES.items() if k != "num_particles"},
        num_synthetic_neighborhoods=64)
    np.testing.assert_array_equal(result["beta_ends"], [1e-2, 1e-2, 1e-1, 1e-1])
    assert len(result["records"]) == 4 and result["info_plane_paths"] == []
    assert result["wall_clock_s"] > 0 and result["entropy_y_bits"] > 0
    epochs = torch.arange(3)
    for end, record in zip(result["beta_ends"], result["records"]):
        want = log_annealed_beta(epochs, config.beta_start, float(end), 3).numpy()
        np.testing.assert_allclose(record.beta, want, rtol=1e-6)
        assert np.isfinite(record.loss).all() and record.kl_per_feature.shape == (3, P)
    assert list(hook.epochs) == [1, 2, 3] and hook.records[0]["bounds"].shape == (4, P, 2)
    first = result["records"]
    assert not np.array_equal(first[0].loss, first[1].loss)     # repeats have their own seeds


def test_stacked_interop_round_trips_a_jax_stacked_tree(jax_run):
    """(h) The JAX sweep's trained stacked tree (leaves [R, ...]) loads into
    a model with replicas and comes back unchanged; ``replica=r`` maps one
    member to a model without replicas and back."""
    tree = jax_run["params"]
    model = _stacked()
    model.load_state_dict(interop.params_from_flax(tree))
    back = interop.params_to_flax(model)
    want = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert got[path].shape[0] == R
        np.testing.assert_array_equal(got[path], value)
    for r in range(R):
        serial = _serial(0)
        serial.load_state_dict(interop.params_from_flax(tree, replica=r))
        for name, value in serial.state_dict().items():
            assert torch.equal(model.carve(r).state_dict()[name], value), name
        one = dict(jax.tree_util.tree_leaves_with_path(
            interop.params_to_flax(model, replica=r)["params"]))
        for path, value in want.items():
            np.testing.assert_array_equal(one[path], value[r])


def test_sweep_refuses_a_model_without_its_replica_axis(bundle):
    config = TrainConfig(**SETTINGS)
    with pytest.raises(ValueError, match="replicas=3"):
        BetaSweepTrainer(_serial(0), bundle, config, 1e-3, ENDS, device="cpu")
    with pytest.raises(ValueError, match="replicas=3"):
        BetaSweepTrainer(_stacked(SEEDS[:2]), bundle, config, 1e-3, ENDS, device="cpu")
    sweep = BetaSweepTrainer(_stacked(), bundle, config, 1e-3, ENDS, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        sweep.fit()
    with pytest.raises(ValueError, match="expected 3"):
        sweep.fit(_generators(SEEDS[:2]))


# ------------------------------------------- DistributedIBModel(replicas=R)
# The boolean model of the CLI's sweep: its encoder bank is one stack of
# R x F encoders, which the stacked interop maps to the JAX tree's [R, F].

DIB_SETTINGS = dict(learning_rate=1e-3, batch_size=8, beta_start=1e-3, beta_end=1e-1,
                    num_pretraining_epochs=0, num_annealing_epochs=2, steps_per_epoch=3,
                    warmup_steps=2, max_val_points=64)
DIB_ENDS = (1e-2, 1e-1, 1.0)


def _stacked_dib(dims, seeds):
    return DistributedIBModel(dims, (8,), (16,), 1, 4, device="cpu", replicas=len(seeds),
                              generator=[torch.Generator().manual_seed(s) for s in seeds])


def test_stacked_dib_equals_serial_models():
    """Replica r of a model built from R generators holds the weights of the
    serial model from the r-th and computes what it computes (1e-6);
    ``carve`` takes members out."""
    dims = (1,) * 10
    seeds = [member_seed(0, r) for r in range(3)]
    stacked = _stacked_dib(dims, seeds)
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.choice([-1.0, 1.0], size=(3, 5, 10)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((3, 10, 5, 4)).astype(np.float32))
    assert stacked.noise_shape(5) == (3, 10, 5, 4)
    prediction, aux = stacked(x, eps=eps)
    for r, seed in enumerate(seeds):
        serial = DistributedIBModel(dims, (8,), (16,), 1, 4, device="cpu",
                                    generator=torch.Generator().manual_seed(seed))
        for name, value in stacked.carve(r).state_dict().items():
            assert torch.equal(value, serial.state_dict()[name]), name
        want, want_aux = serial(x[r], eps=eps[r])
        torch.testing.assert_close(prediction[r], want, rtol=1e-6, atol=1e-6)
        for key in ("kl_per_feature", "mus", "logvars", "embeddings"):
            torch.testing.assert_close(aux[key][r], want_aux[key], rtol=1e-6, atol=1e-6)
        mus, _ = stacked.encode_feature(3, x[:, :, 3:4])
        torch.testing.assert_close(mus[r], serial.encode_feature(3, x[r, :, 3:4])[0],
                                   rtol=1e-6, atol=1e-6)
    pair = stacked.carve([2, 0])
    assert pair.replicas == 2
    assert torch.equal(pair.state_dict()["encoders.mlp.layers.0.kernel"][:10],
                       stacked.state_dict()["encoders.mlp.layers.0.kernel"][20:])


def test_dib_sweep_replays_the_jax_sweep():
    """Three replicas x 2 epochs x 3 steps in one chunk against the JAX vmap
    sweep, resumed from the port's stacked initial weights through the
    stacked interop, each port replica fed its JAX key chain."""
    jax_bundle, bundle = jax_get_dataset("boolean_circuit"), get_dataset("boolean_circuit")
    dims = tuple(bundle.feature_dimensionalities)
    model = _stacked_dib(dims, [member_seed(0, r) for r in range(3)])
    init = {"model": interop.params_to_flax(model)}
    assert init["model"]["params"]["encoders"]["VmapGaussianEncoder_0"]["MLP_0"]["Dense_0"][
        "kernel"].shape[:2] == (3, 10)
    jax_sweep = JaxSweep(JaxDIB(feature_dimensionalities=dims, encoder_hidden=(8,),
                                integration_hidden=(16,), output_dim=1, embedding_dim=4),
                         jax_bundle, JaxTrainConfig(**DIB_SETTINGS), 1e-3, DIB_ENDS)
    states = JaxTrainState(init, jax.vmap(jax_sweep.base.optimizer.init)(init),
                           jnp.zeros(3, jnp.int32))
    histories = jax.vmap(lambda _: jax_history_init(2, 10))(jnp.arange(3))
    keys = jax.random.split(jax.random.key(12), 3)
    jax_states, jax_records = jax_sweep.fit(keys, states=states, histories=histories)

    sweep = BetaSweepTrainer(model, bundle, TrainConfig(**DIB_SETTINGS), 1e-3, DIB_ENDS,
                             device="cpu")
    _, records = sweep.fit(draws=[JaxKeyReplay(keys[r], 2, 0) for r in range(3)])
    want = interop.params_from_flax(jax.device_get(jax_states.params["model"]))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        for r in range(3):
            g, wr = model.member_values(name, got[name], r), model.member_values(name, w, r)
            err = (g - wr).norm().item()
            assert err <= TOL * wr.norm().item() + 1e-8, (name, r, err)
    for got_r, want_r in zip(records, jax_records):
        for name in HISTORY:
            np.testing.assert_allclose(getattr(got_r, name), getattr(want_r, name),
                                       rtol=TOL, atol=TOL, err_msg=name)
