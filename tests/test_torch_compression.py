"""The port's compression schemes against the JAX package's, on the CPU.

The Gaussian distance matrices and ``compression_matrix`` agree with the JAX
package's to 1e-5 on numpy-seeded inputs. The hooks are called, without
training, on one set of weights carried across through ``interop``: a JAX
``BetaSweepTrainer`` of two bfloat16 replicas of a tiny per-particle model
(the north star's setting) beside the port's, and a boolean-circuit
``DistributedIBModel`` for the serial hook's histogram path. Both packages
must write the same file names, the same ``.npz`` contents (channel
parameters to BF16_TOL, as atol = rtol: the JAX hook's jitted encode may keep
the bfloat16 hidden state in float32 where the port rounds it), display the
same rows in the same order (captured by monkeypatching
``save_compression_matrix`` and ``compression_matrix`` of each package's
``viz.compression``), rebuild the same ``saved`` list with ``resume=True``
and render the same paths.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dib_tpu.viz.compression as jax_viz
from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.models.per_particle import PerParticleDIBModel as JaxPerParticle
from dib_tpu.ops.gaussian import bhattacharyya_dist_mat as jax_bhattacharyya
from dib_tpu.ops.gaussian import kl_divergence_mat as jax_kl_mat
from dib_tpu.parallel.sweep import BetaSweepTrainer as JaxSweep
from dib_tpu.parallel.sweep_hooks import SweepCompressionHook as JaxSweepCompressionHook
from dib_tpu.train.hooks import CompressionMatrixHook as JaxCompressionMatrixHook
from dib_tpu.train.loop import DIBTrainer as JaxTrainer
from dib_tpu.train.loop import TrainConfig as JaxTrainConfig
from dib_tpu.train.loop import TrainState as JaxTrainState
import dib_tpu_torch.viz.compression as port_viz
from dib_tpu_torch import interop
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.models import DistributedIBModel, PerParticleDIBModel
from dib_tpu_torch.ops.gaussian import bhattacharyya_dist_mat, kl_divergence_mat
from dib_tpu_torch.parallel import BetaSweepTrainer, SweepCompressionHook
from dib_tpu_torch.train import CompressionMatrixHook, DIBTrainer, TrainConfig

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 2e-2
ENDS = (1e-2, 1.0)
R = len(ENDS)
EPOCHS = (3, 6)
SHOWN = 8                  # max_number_to_display: 15 validation rows, so rng.choice runs
PARTICLES = dict(num_particles=8, encoder_hidden=(8,), embedding_dim=4, num_blocks=1,
                 num_heads=2, key_dim=8, ff_hidden=(8,), head_hidden=(8,),
                 compute_dtype="bfloat16")
DIB = dict(encoder_hidden=(8,), integration_hidden=(8,), output_dim=1, embedding_dim=4)
SETTINGS = dict(batch_size=4, beta_start=1e-3, beta_end=1e-1, num_pretraining_epochs=2,
                num_annealing_epochs=8, steps_per_epoch=1, max_val_points=64)


@pytest.mark.parametrize("name,port_fn,jax_fn", [
    ("bhattacharyya", bhattacharyya_dist_mat, jax_bhattacharyya),
    ("kl", kl_divergence_mat, jax_kl_mat),
])
def test_gaussian_distance_matrices_match_jax(name, port_fn, jax_fn):
    rng = np.random.default_rng(40)
    args = [rng.normal(size=(7, 3)), rng.normal(0, 0.7, size=(7, 3)) - 1.0,
            rng.normal(size=(5, 3)), rng.normal(0, 0.7, size=(5, 3)) - 0.5]
    args = [a.astype(np.float32) for a in args]
    got = port_fn(*(torch.from_numpy(a) for a in args))
    assert got.shape == (7, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_fn(*map(jnp.asarray, args))),
                               rtol=TOL, atol=TOL, err_msg=name)


def test_compression_matrix_matches_jax():
    rng = np.random.default_rng(41)
    mus = rng.normal(size=(9, 4)).astype(np.float32)
    logvars = (rng.normal(0, 0.5, size=(9, 4)) - 1.0).astype(np.float32)
    got = port_viz.compression_matrix(mus, logvars)
    np.testing.assert_allclose(got, jax_viz.compression_matrix(mus, logvars), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=TOL)


class Shown:
    """Records, per rendered file (by its path under ``root``), the channel
    parameters the matrix displays, in display order, by wrapping a
    package's ``save_compression_matrix`` and ``compression_matrix``."""

    def __init__(self, monkeypatch, module, root):
        self.calls = []
        save, matrix = module.save_compression_matrix, module.compression_matrix

        def recording_save(mus, logvars, raw, out_fname, **kwargs):
            self.calls.append([os.path.relpath(out_fname, root)])
            return save(mus, logvars, raw, out_fname, **kwargs)

        def recording_matrix(mus, logvars):
            self.calls[-1] += [np.asarray(mus), np.asarray(logvars)]
            return matrix(mus, logvars)

        monkeypatch.setattr(module, "save_compression_matrix", recording_save)
        monkeypatch.setattr(module, "compression_matrix", recording_matrix)


def _same_shown(got: Shown, want: Shown):
    assert [c[0] for c in got.calls] == [c[0] for c in want.calls]
    for g, w in zip(got.calls, want.calls):
        assert g[1].shape == w[1].shape, g[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL, err_msg=g[0])


@pytest.fixture(scope="module")
def sweeps():
    """(JAX sweep, JAX states, port sweep, port states, port bundle) on one
    set of stacked weights: 2 bfloat16 replicas, 15 validation rows."""
    kwargs = dict(number_particles_to_use=8, num_synthetic_neighborhoods=100)
    bundle, jax_bundle = get_dataset("amorphous_particles", **kwargs), jax_get_dataset(
        "amorphous_particles", **kwargs)
    model = PerParticleDIBModel(**PARTICLES, replicas=R, device="cpu",
                                generator=[torch.Generator().manual_seed(s) for s in (1, 2)])
    params = {"model": interop.params_to_flax(model)}
    jax_sweep = JaxSweep(JaxPerParticle(**PARTICLES), jax_bundle, JaxTrainConfig(**SETTINGS),
                         SETTINGS["beta_start"], ENDS)
    jax_states = JaxTrainState(params, None, jnp.zeros(R, jnp.int32))   # hooks read params
    sweep = BetaSweepTrainer(model, bundle, TrainConfig(**SETTINGS), SETTINGS["beta_start"],
                             ENDS, device="cpu")
    states, _ = sweep.init()
    return jax_sweep, jax_states, sweep, states, bundle


def test_sweep_compression_hook_matches_jax(tmp_path, monkeypatch, sweeps):
    """Same .npz files and contents, same ``resume`` record, same rendered
    paths and displayed rows, replica by replica."""
    jax_sweep, jax_states, sweep, states, bundle = sweeps
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_hook = JaxSweepCompressionHook(jax_dir, features=(0,), max_number_to_display=SHOWN)
    hook = SweepCompressionHook(port_dir, features=(0,), max_number_to_display=SHOWN)
    for epoch in EPOCHS:
        jax_hook(jax_sweep, jax_states, epoch)
        hook(sweep, states, epoch)
    names = sorted(os.listdir(os.path.join(port_dir, "schemes")))
    assert names == sorted(os.listdir(os.path.join(jax_dir, "schemes"))) == \
        [f"scheme_epoch{e}_feature0.npz" for e in EPOCHS]
    for name in names:
        with np.load(os.path.join(port_dir, "schemes", name)) as got, \
                np.load(os.path.join(jax_dir, "schemes", name)) as want:
            assert sorted(got.files) == sorted(want.files)
            assert got["mus"].shape == (R, len(bundle.x_valid), 4)
            assert got["mus"].dtype == got["logvars"].dtype == np.float32
            for key in ("mus", "logvars"):
                np.testing.assert_allclose(got[key], want[key], rtol=BF16_TOL, atol=BF16_TOL)
            np.testing.assert_allclose(got["betas"], want["betas"], rtol=1e-7, atol=0)
            assert int(got["epoch"]) == int(want["epoch"]) and int(got["feature"]) == 0

    def relative(saved, root):
        return [(os.path.relpath(s["path"], root), s["epoch"], s["feature"]) for s in saved]

    assert relative(hook.saved, port_dir) == relative(jax_hook.saved, jax_dir)
    resumed = SweepCompressionHook(port_dir, features=(0,), max_number_to_display=SHOWN,
                                   resume=True)
    jax_resumed = JaxSweepCompressionHook(jax_dir, features=(0,), max_number_to_display=SHOWN,
                                          resume=True)
    assert relative(resumed.saved, port_dir) == relative(hook.saved, port_dir) == \
        relative(jax_resumed.saved, jax_dir)

    shown, jax_shown = Shown(monkeypatch, port_viz, port_dir), Shown(monkeypatch, jax_viz, jax_dir)
    paths, jax_paths = resumed.render(bundle), jax_resumed.render(bundle)
    assert [os.path.relpath(p, port_dir) for p in paths] == \
        [os.path.relpath(p, jax_dir) for p in jax_paths]
    assert len(paths) == R * len(EPOCHS) and all(os.path.exists(p) for p in paths)
    _same_shown(shown, jax_shown)
    assert all(len(c[1]) == SHOWN for c in shown.calls)      # the rng.choice path


def test_compression_matrix_hook_matches_jax(tmp_path, monkeypatch, sweeps):
    """The serial hook on replica 1 of the sweep, at two epochs (its one rng
    advancing across calls): the same files and displayed rows; and the
    sweep hook's deferred render displays, for that replica, the rows this
    serial hook displayed."""
    jax_sweep, jax_states, sweep, states, bundle = sweeps
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shown, jax_shown = Shown(monkeypatch, port_viz, port_dir), Shown(monkeypatch, jax_viz, jax_dir)
    hook = CompressionMatrixHook(port_dir, SHOWN, features=(0,))
    jax_hook = JaxCompressionMatrixHook(jax_dir, SHOWN, features=(0,))
    state_1 = sweep.replica_state(states, 1)
    trainer_1 = sweep.replica_trainer(1, state_1.params["model"])
    for epoch in EPOCHS:
        hook(trainer_1, state_1, epoch)
        jax_hook(jax_sweep.replica_trainer(1), jax_sweep.replica_state(jax_states, 1), epoch)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    _same_shown(shown, jax_shown)
    serial_calls = list(shown.calls)       # the recorders below wrap these ones

    deferred = SweepCompressionHook(str(tmp_path / "deferred"), features=(0,),
                                    max_number_to_display=SHOWN)
    for epoch in EPOCHS:
        deferred(sweep, states, epoch)
    rendered = Shown(monkeypatch, port_viz, str(tmp_path / "deferred" / "replica1" / "compression"))
    deferred.render(bundle)
    replica_1 = [c for c in rendered.calls if not c[0].startswith("..")]
    assert [c[0] for c in replica_1] == [c[0] for c in serial_calls]
    for g, w in zip(replica_1, serial_calls):
        np.testing.assert_array_equal(g[1], w[1])


def test_compression_matrix_hook_histogram_path_matches_jax(tmp_path, monkeypatch):
    """Binary features (fewer than 10 values): one row per value, no draw;
    ``features=None`` would take every channel, here two of them."""
    bundle, jax_bundle = get_dataset("boolean_circuit"), jax_get_dataset("boolean_circuit")
    dims = tuple(bundle.feature_dimensionalities)
    model = DistributedIBModel(dims, **DIB, compute_dtype="bfloat16", device="cpu",
                               generator=torch.Generator().manual_seed(3))
    trainer = DIBTrainer(model, bundle, TrainConfig(**SETTINGS), device="cpu")
    state, _ = trainer.init()
    jax_trainer = JaxTrainer(JaxDIB(feature_dimensionalities=dims, **DIB,
                                    compute_dtype="bfloat16"),
                             jax_bundle, JaxTrainConfig(**SETTINGS))
    jax_state = types.SimpleNamespace(params={"model": interop.params_to_flax(model)})
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shown, jax_shown = Shown(monkeypatch, port_viz, port_dir), Shown(monkeypatch, jax_viz, jax_dir)
    CompressionMatrixHook(port_dir, features=(0, 3))(trainer, state, 5)
    JaxCompressionMatrixHook(jax_dir, features=(0, 3))(jax_trainer, jax_state, 5)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert len(os.listdir(port_dir)) == 2
    _same_shown(shown, jax_shown)
    assert all(len(c[1]) == 2 for c in shown.calls)


def test_sweep_compression_hook_record_rules(tmp_path, sweeps):
    """A call at or before the last saved epoch drops the later entries (a
    resumed run measuring again); another sweep starts a new record; a
    model without a replica axis is refused."""
    _, _, sweep, states, bundle = sweeps
    hook = SweepCompressionHook(str(tmp_path), features=(0,))
    for epoch in (2, 4, 6, 4):
        hook(sweep, states, epoch)
    assert [s["epoch"] for s in hook.saved] == [2, 4]
    other = BetaSweepTrainer(sweep.model, bundle, sweep.config, 1e-3, ENDS, device="cpu")
    hook(other, states, 8)
    assert [s["epoch"] for s in hook.saved] == [8]
    serial = DistributedIBModel((12,) * 8, **DIB, device="cpu",
                                generator=torch.Generator().manual_seed(4))
    with pytest.raises(ValueError, match="replica axis"):
        hook(sweep, types.SimpleNamespace(params={"model": serial}), 10)
