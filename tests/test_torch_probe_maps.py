"""The port's flagship driver and its probe-grid information maps vs the
JAX package, on the tiny configuration of ``tests/test_amorphous_workload.py``.

The numpy helpers (probe grid, phantom features, g(r), density mask) must
equal the JAX package's exactly. ``probe_info_maps`` gets the JAX weights
(``interop.params_from_flax``) and the JAX key schedule's bank indices and
noise, and must match to 1e-4 nats (float32 sums in another order over the
probe rows' logsumexp). The driver test replays a whole JAX run: the JAX
initial weights, the trainer's batch indices and noise, and both hooks'
draws go through the port's seams (``WorkloadDraws``), so both runs take
the same Adam steps; history rows and MI bounds must agree to 1e-5 (nats,
relative or absolute), the probe grids to 1e-4 nats. The JAX driver's plots
are replaced by stubs there to keep the test short; the port's plots are
tested on their own.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dib_tpu.workloads.amorphous as jax_workload
from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.models.per_particle import PerParticleDIBModel as JaxPerParticle
from dib_tpu.train.loop import DIBTrainer as JaxTrainer
from dib_tpu.viz.probe_maps import density_mask as jax_density_mask
from dib_tpu_torch import interop
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.models import PerParticleDIBModel
from dib_tpu_torch.viz import info_plane, probe_maps
from dib_tpu_torch.workloads import (
    AmorphousWorkloadConfig,
    ProbeGridHook,
    WorkloadDraws,
    pair_correlation,
    probe_features_for_type,
    probe_grid_positions,
    probe_info_maps,
    run_amorphous_protocols,
    run_amorphous_workload,
)

torch.set_num_threads(1)

TOL = 1e-5
PROBE_TOL = 1e-4
TINY_MODEL = dict(encoder_hidden=(16,), embedding_dim=4, num_blocks=1, num_heads=2,
                  key_dim=8, ff_hidden=(8,), head_hidden=(16,))
CONFIG = dict(num_steps=40, batch_size=8, eval_every=20, probe_every=20, number_particles=12,
              grid_side=6, grid_extent=6.0, probe_data_batch=64, mi_eval_batch_size=64,
              mi_eval_batches=1, warmup_steps=5)
FETCH = dict(num_synthetic_neighborhoods=64)


@pytest.fixture(scope="module")
def bundle():
    return get_dataset("amorphous_particles", number_particles_to_use=12, **FETCH)


def _jax_init(key):
    """The JAX driver's model and its initial weights under ``fit(key)``;
    returns them with the key ``fit`` goes on with."""
    config = jax_workload.AmorphousWorkloadConfig(**CONFIG)
    model = JaxPerParticle(num_particles=12, **TINY_MODEL)
    jax_bundle = jax_get_dataset("amorphous_particles", number_particles_to_use=12, **FETCH)
    key, k_init = jax.random.split(key)
    state, _ = JaxTrainer(model, jax_bundle, config.train_config(1)).init(k_init)
    return model, state.params["model"], key


class JaxKeyReplay:
    """The trainer draws of ``dib_tpu`` ``DIBTrainer.fit(key, hook_every=...)``
    after its init split, in replacement mode."""

    def __init__(self, key, num_epochs, hook_every):
        self.epoch_keys, done = [], 0
        while done < num_epochs:
            this = min(hook_every, num_epochs - done)
            key, k_chunk = jax.random.split(key)
            self.epoch_keys += list(jax.random.split(k_chunk, this))
            done += this

    def start_epoch(self, n, steps, batch_size, sampling):
        keys = jax.random.split(self.epoch_keys.pop(0), steps + 1)
        self.val_key = keys[-1]
        pairs = [jax.random.split(k) for k in keys[:-1]]
        self.noise_keys = [p[1] for p in pairs]
        idx = [jax.random.randint(p[0], (batch_size,), 0, n) for p in pairs]
        return torch.from_numpy(np.array(jnp.stack(idx))).long()

    def step_noise(self, step, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.noise_keys[step], shape)))

    def val_noise(self, chunk, num_chunks, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.val_key, shape)))


class JaxInfoReplay:
    """``InfoPerFeatureHook(seed=0)``'s draws: one key split per call, then
    per eval batch the row indices and one noise key per particle channel.
    The noise is applied to the port's own encodings."""

    def __init__(self, batch, batches):
        self.key, self.batch, self.batches = jax.random.key(0), batch, batches

    def __call__(self, model, rows):
        self.key, k = jax.random.split(self.key)
        idx, us = [], []
        for kb in jax.random.split(k, self.batches):
            k_idx, k_mi = jax.random.split(kb)
            batch_idx = torch.from_numpy(np.array(
                jax.random.randint(k_idx, (self.batch,), 0, rows.shape[0]))).long()
            with torch.no_grad():
                mus, logvars = model.encode(rows[batch_idx])            # [P, B, d]
            keys = jax.random.split(k_mi, mus.shape[0])
            eps = jax.vmap(lambda kf: jax.random.normal(kf, tuple(mus.shape[1:])))(keys)
            idx.append(batch_idx)
            us.append(mus + torch.from_numpy(np.array(eps)) * torch.exp(0.5 * logvars))
        return torch.stack(idx), torch.stack(us)


def jax_probe_draws(key, n_data, config):
    """``probe_info_maps``' draws under ``key``: the bank indices and each
    type's noise (``mi_sandwich_probe``'s ``reparameterize``)."""
    k_bank, k_type1, k_type2 = jax.random.split(key, 3)
    idx = np.array(jax.random.randint(k_bank, (config.probe_data_batch,), 0, n_data))
    shape = (config.grid_side ** 2, TINY_MODEL["embedding_dim"])
    eps = tuple(torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
                for k in (k_type1, k_type2))
    return torch.from_numpy(idx).long(), eps


class JaxProbeReplay:
    """``ProbeGridHook(seed=0)``'s draws: one key split per call."""

    def __init__(self, config):
        self.key, self.config = jax.random.key(0), config

    def __call__(self, model, data_particles):
        self.key, k = jax.random.split(self.key)
        return jax_probe_draws(k, data_particles.shape[0], self.config)


# ------------------------------------------------------------------ helpers

def test_probe_helpers_equal_jax():
    for side, extent in ((6, 6.0), (5, 2.0), (100, 8.0)):
        got = probe_grid_positions(side, extent)
        np.testing.assert_array_equal(got, jax_workload.probe_grid_positions(side, extent))
        for type_id in (1, 2):
            np.testing.assert_array_equal(
                probe_features_for_type(got, type_id),
                jax_workload.probe_features_for_type(got, type_id))
    rng = np.random.default_rng(3)
    sets = np.zeros((40, 30, 12), np.float32)
    sets[..., 4] = np.sqrt(rng.uniform(4.0, 16.0, size=(40, 30)))
    sets[:, -3:, 4] = 0.0                                    # zero-padded slots
    for kwargs in ({}, {"num_bins": 32, "max_radius": 5.0}):
        for g, w in zip(pair_correlation(sets, **kwargs),
                        jax_workload.pair_correlation(sets, **kwargs)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("g_r", [
    [0, 0, 1, 2, 0, 3, 0, 0],      # core, an interior gap, an empty outside
    [1, 1, 0, 1, 1, 1, 1, 1],      # first bin occupied: no core
    [0] * 8,                        # nothing supported
])
def test_density_mask_equals_jax(g_r):
    positions = probe_grid_positions(7, 4.0)
    g_r = np.asarray(g_r, np.float64)
    right_edges = np.linspace(0.5, 4.0, 8)
    got = probe_maps.density_mask(positions, g_r, right_edges, 7)
    np.testing.assert_array_equal(got, jax_density_mask(positions, g_r, right_edges, 7))
    with pytest.raises(ValueError, match="RIGHT edges"):
        probe_maps.density_mask(positions, g_r, np.linspace(0, 4.0, 9), 7)


# --------------------------------------------------------------- probe maps

def test_probe_info_maps_match_jax(bundle):
    config = AmorphousWorkloadConfig(**CONFIG)
    jax_model, jax_params, _ = _jax_init(jax.random.key(5))
    data = np.asarray(bundle.extras["sets_train"]).reshape(-1, 12)
    key = jax.random.key(6)
    want = jax_workload.probe_info_maps(jax_model, jax_params, data, key,
                                        jax_workload.AmorphousWorkloadConfig(**CONFIG))
    model = PerParticleDIBModel(num_particles=12, **TINY_MODEL, device="cpu")
    model.load_state_dict(interop.params_from_flax(jax_params))
    got = probe_info_maps(model, data, config, draws=jax_probe_draws(key, len(data), config))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (6, 6, 2)
        np.testing.assert_allclose(g, w, rtol=PROBE_TOL, atol=PROBE_TOL)
    # seeded draws: the same generator seed gives the same grids
    seeded = [probe_info_maps(model, data, config, generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    for a, b in zip(*seeded):
        np.testing.assert_array_equal(a, b)


def test_probe_hook_and_info_plane_write_pngs(tmp_path, bundle):
    config = AmorphousWorkloadConfig(**CONFIG)
    model = PerParticleDIBModel(num_particles=12, **TINY_MODEL, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    hook = ProbeGridHook(str(tmp_path / "maps"), model, bundle.extras["sets_train"], config)
    hook(None, None, 3)
    assert (tmp_path / "maps" / "info_map_step3.png").stat().st_size > 0
    assert list(hook.grids_by_step) == [3] and hook.grids_by_step[3][0].shape == (6, 6, 2)
    assert hook.masks[0].shape == (6, 6)
    quiet = ProbeGridHook(str(tmp_path / "quiet"), model, bundle.extras["sets_train"], config,
                          render=False)
    quiet(None, None, 3)
    assert not (tmp_path / "quiet").exists()
    np.testing.assert_array_equal(quiet.grids_by_step[3][1], hook.grids_by_step[3][1])
    kl = np.abs(np.random.default_rng(0).normal(size=(10, 3)))
    path = info_plane.save_distributed_info_plane(kl, np.linspace(1.0, 0.5, 10),
                                                  str(tmp_path), entropy_y=1.0)
    assert path == str(tmp_path / "distributed_info_plane.png")
    assert (tmp_path / "distributed_info_plane.png").stat().st_size > 0


def test_plots_name_matplotlib_when_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="save_info_maps needs matplotlib"):
        probe_maps.save_info_maps([np.zeros((2, 2, 2))], str(tmp_path / "x.png"))
    with pytest.raises(ImportError, match="save_distributed_info_plane needs matplotlib"):
        info_plane.save_distributed_info_plane(np.zeros((4, 2)), np.zeros(4), str(tmp_path))


# ------------------------------------------------------------------- driver

@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """(JAX result, port result) of one tiny run, the port replaying the JAX
    run's draws."""
    outdir = str(tmp_path_factory.mktemp("amorphous"))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_workload, "save_info_maps", lambda *a, **k: None)
        patch.setattr(jax_workload, "save_distributed_info_plane", lambda *a, **k: None)
        want = jax_workload.run_amorphous_workload(
            0, config=jax_workload.AmorphousWorkloadConfig(**CONFIG), outdir=outdir,
            model_overrides=TINY_MODEL, **FETCH)
    config = AmorphousWorkloadConfig(**CONFIG)
    _, jax_params, fit_key = _jax_init(jax.random.key(0))
    draws = WorkloadDraws(
        params=interop.params_from_flax(jax_params),
        train=JaxKeyReplay(fit_key, config.num_steps, math.gcd(20, 20)),
        info=JaxInfoReplay(config.mi_eval_batch_size, config.mi_eval_batches),
        probe=JaxProbeReplay(config))
    got = run_amorphous_workload(0, config, outdir=outdir, model_overrides=TINY_MODEL,
                                 device="cpu", render=False, draws=draws, **FETCH)
    return want, got


def test_driver_replays_the_jax_history(driver_runs):
    want, got = driver_runs
    assert set(got) == set(want)
    assert got["history"].beta.shape == (40,) and got["info_plane_path"] is None
    assert got["entropy_y_bits"] == want["entropy_y_bits"]
    assert got["state"].epoch == 40
    ln2 = np.log(2.0)
    for name in ("beta", "kl_per_feature", "loss", "val_loss", "metric", "val_metric"):
        scale = 1.0 if name in ("beta", "metric", "val_metric") else ln2    # bits -> nats
        np.testing.assert_allclose(getattr(got["history"], name) * scale,
                                   getattr(want["history"], name) * scale,
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_driver_replays_the_jax_mi_bounds(driver_runs):
    want, got = driver_runs
    np.testing.assert_array_equal(got["mi_epochs"], want["mi_epochs"])
    assert got["mi_bounds_bits"].shape == (2, 12, 2)
    np.testing.assert_allclose(got["mi_bounds_bits"] * np.log(2.0),
                               want["mi_bounds_bits"] * np.log(2.0), rtol=TOL, atol=TOL)


def test_driver_replays_the_jax_probe_grids(driver_runs):
    want, got = driver_runs
    assert sorted(got["probe_grids"]) == sorted(want["probe_grids"]) == [20, 40]
    for epoch, grids in got["probe_grids"].items():
        for g, w in zip(grids, want["probe_grids"][epoch]):
            assert g.shape == (6, 6, 2)
            np.testing.assert_allclose(g, w, rtol=PROBE_TOL, atol=PROBE_TOL)


def test_protocol_loop_runs_each_protocol_on_its_own_data(tmp_path):
    config = AmorphousWorkloadConfig(**{**CONFIG, "num_steps": 4, "eval_every": 2,
                                        "probe_every": 0, "number_particles": 6,
                                        "warmup_steps": 0})
    results = run_amorphous_protocols(
        0, config=config, outdir=str(tmp_path), model_overrides=TINY_MODEL, device="cpu",
        render=False, **FETCH)
    assert list(results) == ["GradualQuench", "RapidQuench"]
    for protocol, result in results.items():
        assert result["bundle"].extras["protocol"] == protocol
        assert result["probe_grids"] == {} and result["mi_bounds_bits"].shape == (2, 6, 2)
        assert np.isfinite(result["history"].loss).all()
    a, b = (r["bundle"].x_train for r in results.values())
    assert a.shape == b.shape and not np.array_equal(a, b)      # independent surrogates
    assert not any(tmp_path.iterdir())                           # render=False writes nothing


def test_driver_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_amorphous_workload(0, AmorphousWorkloadConfig(**CONFIG),
                               model_overrides=TINY_MODEL, render=False, **FETCH)
