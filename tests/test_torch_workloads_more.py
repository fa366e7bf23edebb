"""The boolean, characterization and radial-shells workloads of the port
against the JAX package's, on the CPU at tiny sizes.

Tolerances: ``BooleanDIBModel`` with weights carried from Flax and the same
noise, logits and KL 1e-6; one training step against JAX's gradients and
optax's Adam 1e-5 on every weight; ``channel_mi_bounds`` with u drawn by
JAX's ``reparameterize`` 1e-5 nats; the exact informations, Shapley values,
rank agreements and ``monte_carlo_mi_bits`` equal; the logistic
regression's |coef| 1e-3 of the largest against scikit-learn's fit to its
optimum (``tol=1e-8``; at its default tolerance L-BFGS stops short of it).
The drivers at a few epochs: keys and shapes as the JAX results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dib_tpu.workloads as jax_wl
from dib_tpu.data.boolean_circuit import fetch_boolean_circuit as jax_fetch_boolean
from dib_tpu_torch import interop
import dib_tpu_torch.workloads as port_wl
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.ops.entropy import LN2
from dib_tpu_torch.workloads.boolean import BooleanTrainer

torch.set_num_threads(1)

CONFIG = dict(learning_rate=1e-2, batch_size=64, num_steps=6, mi_every=3,
              integration_hidden=(8, 8), embedding_dim=2)


@pytest.fixture(scope="module")
def jax_boolean():
    """The JAX trainer on the paper circuit, its initial state and the state
    after one step (one compile of its chunk)."""
    bundle = jax_fetch_boolean()
    config = jax_wl.BooleanWorkloadConfig(**CONFIG)
    trainer = jax_wl.BooleanTrainer(bundle, config)
    state = trainer.init(jax.random.key(0))
    params = jax.device_get(state.params)
    key = jax.random.key(5)
    stepped, stats = trainer.run_chunk(state, key, 1)
    return dict(bundle=bundle, config=config, trainer=trainer, params=params, key=key,
                stepped=jax.device_get(stepped.params), stats=jax.device_get(stats))


def _port_trainer(jax_boolean):
    config = port_wl.BooleanWorkloadConfig(**CONFIG)
    trainer = BooleanTrainer(get_dataset("boolean_circuit"), config, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    state.model.load_state_dict(interop.params_from_flax(jax_boolean["params"]))
    return trainer, state


def test_boolean_model_matches_flax(jax_boolean):
    trainer, state = _port_trainer(jax_boolean)
    x = jax_boolean["bundle"].x_train[:50]
    noise_key = jax.random.key(9)
    logits, aux = jax_boolean["trainer"].model.apply(jax_boolean["params"], jnp.asarray(x),
                                                     noise_key)
    eps = jax.random.normal(noise_key, aux["mus"].shape)
    got, got_aux = state.model(torch.from_numpy(x), eps=torch.from_numpy(np.array(eps)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_aux["kl_per_feature"].detach().numpy(),
                               np.asarray(aux["kl_per_feature"]), rtol=0, atol=1e-6)
    round_trip = interop.params_to_flax(state.model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_boolean["params"]):
        node = round_trip
        for part in path:
            node = node[part.key]
        np.testing.assert_array_equal(node, leaf)


def test_one_boolean_step_matches_jax_and_optax(jax_boolean):
    """The step's draws replayed from the JAX chunk's key: the batch rows and
    the encoders' noise."""
    trainer, state = _port_trainer(jax_boolean)
    (k_step,) = jax.random.split(jax_boolean["key"], 1)
    k_batch, k_noise = jax.random.split(k_step)
    idx = jax.random.randint(k_batch, (CONFIG["batch_size"],), 0, 1024)
    eps = jax.random.normal(k_noise, state.model.noise_shape(CONFIG["batch_size"]))
    beta = float(jax_boolean["stats"]["beta"][0])
    stats = trainer.train_step(state, torch.from_numpy(np.asarray(idx)),
                               torch.from_numpy(np.asarray(eps)), beta)
    np.testing.assert_allclose(float(stats["task"]), jax_boolean["stats"]["task"][0], atol=1e-6)
    want = interop.params_from_flax(jax_boolean["stepped"])
    for name, value in state.model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=1e-5)


def test_channel_mi_bounds_match_jax_on_the_same_draw(jax_boolean):
    trainer, state = _port_trainer(jax_boolean)
    key = jax.random.key(11)
    jax_state = jax_boolean["trainer"].init(jax.random.key(0))
    want_lower, want_upper = jax_boolean["trainer"].channel_mi_bounds(jax_state, key)
    _, aux = jax_boolean["trainer"].model.apply(jax_boolean["params"],
                                                jnp.asarray(jax_boolean["bundle"].x_train),
                                                key, sample=False)
    keys = jax.random.split(key, aux["mus"].shape[0])
    from dib_tpu.ops.gaussian import reparameterize

    u = jax.vmap(reparameterize)(keys, aux["mus"], aux["logvars"])
    lower, upper = trainer.channel_mi_bounds(state, u=torch.from_numpy(np.asarray(u)))
    np.testing.assert_allclose(lower.numpy(), np.asarray(want_lower), rtol=0, atol=1e-5)
    np.testing.assert_allclose(upper.numpy(), np.asarray(want_upper), rtol=0, atol=1e-5)


def test_exact_oracles_match_jax():
    bundle = get_dataset("boolean_circuit")
    table = bundle.extras["truth_table"]
    subsets = port_wl.boolean.exact_subset_informations(table, 10)
    assert port_wl.best_subsets_by_size(subsets) == jax_wl.best_subsets_by_size(subsets)
    shapley = port_wl.shapley_values_bits(table, 10, subsets)
    np.testing.assert_array_equal(shapley, jax_wl.shapley_values_bits(table, 10, subsets))
    alloc = np.random.default_rng(0).random(10)
    from dib_tpu.workloads.boolean import allocation_rank_agreement

    assert port_wl.allocation_rank_agreement(alloc, shapley) == \
        allocation_rank_agreement(alloc, shapley)
    assert port_wl.allocation_rank_agreement(np.ones(10), shapley) == 0.0


def test_logistic_regression_importances_match_scikit_learn():
    from sklearn.linear_model import LogisticRegression

    bundle = get_dataset("boolean_circuit")
    got = port_wl.logistic_regression_importances(bundle.x_train, bundle.y_train)
    fit = LogisticRegression(max_iter=5000, tol=1e-8).fit(bundle.x_train,
                                                          bundle.y_train.reshape(-1))
    want = np.abs(fit.coef_[0])
    assert np.max(np.abs(got - want)) <= 1e-3 * np.max(want)


def test_overlapped_checks_equal_direct_bounds():
    """Each check, measured on a snapshot while the next chunk trains, is
    ``channel_mi_bounds`` on the weights at its step with the checks'
    generator as it stood (one [F, N, d] draw per check)."""
    config = port_wl.BooleanWorkloadConfig(**CONFIG)
    trainer = BooleanTrainer(get_dataset("boolean_circuit"), config, device="cpu")
    state, history = trainer.fit(torch.Generator().manual_seed(1),
                                 mi_generator=torch.Generator().manual_seed(2))
    assert history["mi_steps"].tolist() == [3, 6]
    assert history["mi_lower_bits"].shape == history["mi_upper_bits"].shape == (2, 10)
    assert [len(history[k]) for k in ("task", "kl", "beta")] == [6, 6, 6]
    generator = torch.Generator().manual_seed(2)
    torch.randn(state.model.noise_shape(1024), generator=generator)
    lower, upper = trainer.channel_mi_bounds(state, generator)
    np.testing.assert_array_equal(lower.numpy() / LN2, history["mi_lower_bits"][-1])
    np.testing.assert_array_equal(upper.numpy() / LN2, history["mi_upper_bits"][-1])


def test_boolean_workload_keys_and_shapes_match_jax(jax_boolean):
    got = port_wl.run_boolean_workload(0, port_wl.BooleanWorkloadConfig(**CONFIG), device="cpu")
    want = jax_wl.run_boolean_workload(0, jax_boolean["config"])
    assert got.keys() == want.keys()
    for name in ("history", ):
        assert got[name].keys() == want[name].keys()
        for key in want[name]:
            assert np.shape(got[name][key]) == np.shape(want[name][key]), key
    for name in ("shapley_bits", "logreg_importances", "final_allocation_bits",
                 "allocation_persistence_bits"):
        assert np.shape(got[name]) == np.shape(want[name]), name
    assert got["subset_informations"] == want["subset_informations"]
    assert got["entropy_y_bits"] == want["entropy_y_bits"]
    assert got["history"]["mi_steps"].tolist() == want["history"]["mi_steps"].tolist()


def test_monte_carlo_truth_matches_jax():
    for bits in (2, 0):
        channel = port_wl.SyntheticChannel(input_bits=bits, scale=1.5, embedding_dim=4)
        jax_channel = jax_wl.SyntheticChannel(input_bits=bits, scale=1.5, embedding_dim=4)
        assert port_wl.monte_carlo_mi_bits(channel, 500, 64, seed=3) == \
            jax_wl.monte_carlo_mi_bits(jax_channel, 500, 64, seed=3)


def test_characterization_matches_jax_in_keys_and_shapes():
    kwargs = dict(input_bits_list=(1, 0), scales=(0.5, 2.0), batch_sizes=(16, 32),
                  num_repeats=2, mc_samples=300, embedding_dim=4)
    got = port_wl.run_characterization(device="cpu", **kwargs)
    want = jax_wl.run_characterization(**kwargs)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
        assert (a.batch_size, a.mc_truth) == (b.batch_size, b.mc_truth)
        assert dataclasses.asdict(a.channel) == dataclasses.asdict(b.channel)
        assert a.lower_mean <= a.upper_mean + 0.02
        assert np.isfinite([a.lower_std, a.upper_std]).all()


def test_radial_shells_match_jax_in_keys_and_shapes(tmp_path):
    config = dict(num_pretraining_epochs=1, num_annealing_epochs=1, eval_every=1,
                  mi_eval_batch_size=16, mi_eval_batches=1, encoder_hidden=(4,),
                  integration_hidden=(4,), embedding_dim=2, num_shells=3, batch_size=32)
    got = port_wl.run_radial_shells_workload(0, port_wl.RadialShellsConfig(**config),
                                             device="cpu", render=False,
                                             num_synthetic_neighborhoods=48)
    want = jax_wl.run_radial_shells_workload(0, jax_wl.RadialShellsConfig(**config),
                                             outdir=str(tmp_path),
                                             num_synthetic_neighborhoods=48)
    assert got.keys() == want.keys()
    for name in ("mi_bounds_bits", "mi_epochs", "final_shell_profile_bits",
                 "peak_shell_profile_bits"):
        assert np.shape(got[name]) == np.shape(want[name]), name
    assert got["mi_epochs"].tolist() == want["mi_epochs"].tolist() == [1, 2]
    assert got["entropy_y_bits"] == want["entropy_y_bits"]
    assert got["history"].kl_per_feature.shape == want["history"].kl_per_feature.shape
    assert got["info_plane_path"] is None and want["info_plane_path"]
