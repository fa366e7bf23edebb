"""The port's checkpoints: the cases of ``tests/test_checkpoint.py`` on
``dib_tpu_torch.train.checkpoint``.

A tiny ``DistributedIBModel`` on the boolean circuit (encoders (8,),
integration (16,), embedding 4, 2 + 4 epochs of 2 steps), serial and as a
sweep of two replicas. A run interrupted at a chunk boundary and resumed
from its checkpoint into a model built from another seed must equal the
uninterrupted run exactly: every history row, every weight and every leaf
of the final checkpoint (Adam's moments, the generators' states) bit for
bit. No tolerance: the same operations run on the same values.
"""

import os

import numpy as np
import pytest
import torch

from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.parallel import BetaSweepTrainer, SweepInfoPerFeatureHook, member_seed
from dib_tpu_torch.train import DIBTrainer, TrainConfig, history_extend
from dib_tpu_torch.workloads import AmorphousWorkloadConfig, run_amorphous_sweep
from dib_tpu_torch.train.checkpoint import (
    CheckpointCorruptionError,
    CheckpointHook,
    DIBCheckpointer,
    param_structure_hash,
)

torch.set_num_threads(1)

SETTINGS = dict(learning_rate=1e-3, batch_size=64, beta_start=1e-3, beta_end=1e-1,
                num_pretraining_epochs=2, num_annealing_epochs=4, steps_per_epoch=2,
                warmup_steps=2, max_val_points=64)
ENDS = (0.1, 1.0)
CHUNK = 2


@pytest.fixture(scope="module")
def bundle():
    return get_dataset("boolean_circuit")


def _model(bundle, seed=0, replicas=None, integration=(16,)):
    generator = (torch.Generator().manual_seed(seed) if replicas is None
                 else [torch.Generator().manual_seed(member_seed(seed, r))
                       for r in range(replicas)])
    return DistributedIBModel(tuple(bundle.feature_dimensionalities), (8,), integration, 1, 4,
                              device="cpu", generator=generator, replicas=replicas)


def _trainer(bundle, sweep, seed=0, **model_kwargs):
    config = TrainConfig(**SETTINGS)
    if sweep:
        return BetaSweepTrainer(_model(bundle, seed, len(ENDS), **model_kwargs), bundle, config,
                                1e-3, ENDS, device="cpu")
    return DIBTrainer(_model(bundle, seed, **model_kwargs), bundle, config, device="cpu")


def _generators(sweep, seed=5):
    if sweep:
        return [torch.Generator().manual_seed(member_seed(seed, r)) for r in range(len(ENDS))]
    return torch.Generator().manual_seed(seed)


def _leaves(ckpt, step):
    with np.load(os.path.join(ckpt.step_dir(step), "leaves.npz")) as data:
        return {name: data[name] for name in data.files}


def _fit_checkpoints(tmp_path, bundle, name="ck", num_epochs=None):
    ckpt = DIBCheckpointer(str(tmp_path / name))
    trainer = _trainer(bundle, False)
    trainer.fit(_generators(False), num_epochs=num_epochs, hooks=[CheckpointHook(ckpt)],
                hook_every=CHUNK)
    return ckpt


@pytest.mark.parametrize("sweep", [False, True], ids=["serial", "sweep"])
def test_resume_is_bit_identical(tmp_path, bundle, sweep):
    whole = DIBCheckpointer(str(tmp_path / "whole"))
    trainer = _trainer(bundle, sweep)
    _, want = trainer.fit(_generators(sweep), hooks=[CheckpointHook(whole)], hook_every=CHUNK)
    want_params = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    part = DIBCheckpointer(str(tmp_path / "part"))
    _trainer(bundle, sweep).fit(_generators(sweep), num_epochs=4,
                                hooks=[CheckpointHook(part)], hook_every=CHUNK)
    assert part.all_steps() == [2, 4]
    resumed = _trainer(bundle, sweep, seed=9)          # other weights, overwritten by restore
    state, history, generators = part.restore(resumed, chunk_size=CHUNK)
    assert state.epoch == 4 and history["cursor"] == 4
    assert len(generators) == len(ENDS) if sweep else generators.dtype == torch.uint8
    # a sweep's fit names them states and histories
    _, got = resumed.fit(generators, 2, [CheckpointHook(part)], CHUNK, state, history)

    for got_r, want_r in zip(got if sweep else [got], want if sweep else [want]):
        for name in ("beta", "kl_per_feature", "loss", "val_loss", "metric", "val_metric"):
            np.testing.assert_array_equal(getattr(got_r, name), getattr(want_r, name), name)
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, want_params[name]), name
    assert part.all_steps() == whole.all_steps() == [2, 4, 6]      # max_to_keep=3
    final, whole_final = _leaves(part, 6), _leaves(whole, 6)
    assert final.keys() == whole_final.keys()
    assert any(k.startswith("optimizer/") for k in final)
    assert sum(k.startswith("generators/") for k in final) == (len(ENDS) if sweep else 1)
    for name, value in whole_final.items():
        np.testing.assert_array_equal(final[name], value, name)


def test_restore_rejects_mismatched_chunk_size(tmp_path, bundle):
    ckpt = _fit_checkpoints(tmp_path, bundle, num_epochs=3)    # steps 2 and 3 (partial chunk)
    with pytest.raises(ValueError, match="hook_every=2"):
        ckpt.restore(_trainer(bundle, False), step=2, chunk_size=3)
    with pytest.raises(ValueError, match="not on the chunk grid"):
        ckpt.restore(_trainer(bundle, False), step=3, chunk_size=2)
    state, _, _ = ckpt.restore(_trainer(bundle, False), step=3)   # no contract asked
    assert state.epoch == 3 and ckpt.restored_chunk_size == 2


def test_manifest_mismatch_names_the_differing_leaves(tmp_path, bundle):
    ckpt = _fit_checkpoints(tmp_path, bundle, num_epochs=2)
    other = _trainer(bundle, False, integration=(8,))
    with pytest.raises(ValueError) as excinfo:
        ckpt.restore(other)
    message = str(excinfo.value)
    assert "checkpoint-only leaves" in message and "template-only leaves" in message
    assert "model.integration.layers.0.kernel [40, 16]" in message
    assert param_structure_hash(other.init()[0].params) in message


def test_restore_without_checkpoint_raises(tmp_path, bundle):
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        DIBCheckpointer(str(tmp_path / "empty")).restore(_trainer(bundle, False))


def test_truncated_step_raises_actionable_corruption_error(tmp_path, bundle):
    ckpt = _fit_checkpoints(tmp_path, bundle)
    path = os.path.join(ckpt.step_dir(6), "leaves.npz")
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointCorruptionError) as excinfo:
        ckpt.restore(_trainer(bundle, False), step=6)
    assert "step 6" in str(excinfo.value) and "restore_latest_intact" in str(excinfo.value)


def _flip_byte(path):
    with open(path, "rb+") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))


def test_restore_latest_intact_falls_back_past_corruption(tmp_path, bundle):
    ckpt = _fit_checkpoints(tmp_path, bundle)
    _flip_byte(os.path.join(ckpt.step_dir(6), "leaves.npz"))
    skipped = []
    trainer = _trainer(bundle, False)
    state, history, generator = ckpt.restore_latest_intact(trainer, chunk_size=CHUNK,
                                                           on_fallback=skipped.append)
    assert state.epoch == 4 and history["cursor"] == 4
    assert [s["step"] for s in skipped] == ckpt.fallback_skipped_steps == [6]
    moved = skipped[0]["quarantined"]
    assert os.path.basename(os.path.dirname(moved)) == "quarantine"
    assert os.path.exists(os.path.join(moved, "QUARANTINE.json"))
    assert os.path.exists(os.path.join(moved, "leaves.npz"))     # moved, never deleted
    assert ckpt.all_steps() == [2, 4]
    trainer.fit(generator, num_epochs=2, state=state, history=history,
                hooks=[CheckpointHook(ckpt)], hook_every=CHUNK)
    assert ckpt.latest_step == 6                               # the gap saved again
    again, _, _ = ckpt.restore(_trainer(bundle, False), step=6, chunk_size=CHUNK)
    assert again.epoch == 6


def test_restore_latest_intact_raises_when_everything_is_corrupt(tmp_path, bundle):
    ckpt = _fit_checkpoints(tmp_path, bundle)
    for step in ckpt.all_steps():
        _flip_byte(os.path.join(ckpt.step_dir(step), "manifest.json"))
    with pytest.raises(CheckpointCorruptionError, match="corrupt"):
        ckpt.restore_latest_intact(_trainer(bundle, False), chunk_size=CHUNK)
    assert ckpt.fallback_skipped_steps == [6, 4, 2]
    assert ckpt.all_steps() == []
    assert sorted(os.listdir(os.path.join(ckpt.directory, "quarantine"))) == ["2", "4", "6"]


def test_a_pickled_leaf_is_refused(tmp_path, bundle):
    """Nothing is unpickled on load: an object array in a step is corruption."""
    ckpt = _fit_checkpoints(tmp_path, bundle, num_epochs=2)
    leaves = _leaves(ckpt, 2)
    leaves["epoch"] = np.array([{"not": "a number"}], dtype=object)
    np.savez(os.path.join(ckpt.step_dir(2), "leaves.npz"), **leaves)
    with pytest.raises(CheckpointCorruptionError, match="failed to read back"):
        ckpt.restore(_trainer(bundle, False))


def test_history_extend_on_resume(tmp_path, bundle):
    """A longer budget than the checkpointed run's: the restored history is
    grown with ``history_extend``, its recorded rows kept."""
    ckpt = _fit_checkpoints(tmp_path, bundle)
    trainer = _trainer(bundle, False)
    state, history, generator = ckpt.restore(trainer, chunk_size=CHUNK)
    assert history["beta"].shape == (6,) and history["cursor"] == 6
    with pytest.raises(ValueError, match="history_extend"):
        trainer.fit(generator, num_epochs=2, state=state, history=history)
    recorded = history["loss"].clone()
    grown = history_extend(history, 2)
    state, record = trainer.fit(generator, num_epochs=2, state=state, history=grown,
                                hooks=[CheckpointHook(ckpt)], hook_every=CHUNK)
    assert state.epoch == 8 and record.loss.shape == (8,)
    np.testing.assert_array_equal(record.loss[:6], recorded.numpy())
    restored, extended, _ = ckpt.restore(_trainer(bundle, False))
    assert restored.epoch == 8 and extended["beta"].shape == (8,)


class _Crash(Exception):
    pass


class _CrashAt:
    """A hook that raises at ``epoch``, as a process killed mid-run."""

    def __init__(self, epoch):
        self.epoch = epoch

    def __call__(self, sweep, states, epoch):
        if epoch == self.epoch:
            raise _Crash(f"crash at epoch {epoch}")


def test_sweep_driver_resumes_bit_for_bit(tmp_path):
    """``run_amorphous_sweep(checkpoint_dir=)``: a run that crashes after its
    first chunk's checkpoint and is launched again resumes from it; records,
    weights and the MI hook's measurement at the epoch it measures again
    equal the uninterrupted run's bit for bit."""
    config = AmorphousWorkloadConfig(num_steps=8, batch_size=4, number_particles=8,
                                     warmup_steps=2)
    kwargs = dict(beta_ends=(1e-2, 1e-1), steps_per_epoch=2, chunk_epochs=2, device="cpu",
                  render=False, num_synthetic_neighborhoods=64,
                  model_overrides=dict(encoder_hidden=(8,), embedding_dim=4, num_blocks=1,
                                       num_heads=2, key_dim=8, ff_hidden=(8,),
                                       head_hidden=(8,)))
    whole_hook = SweepInfoPerFeatureHook(16, 1)
    whole = run_amorphous_sweep(0, config, hooks=[whole_hook],
                                checkpoint_dir=str(tmp_path / "whole"), **kwargs)
    assert whole["resumed_from_epoch"] is None and list(whole_hook.epochs) == [2, 4]

    ckpt, persist = str(tmp_path / "ckpt"), str(tmp_path / "bounds")
    with pytest.raises(_Crash):
        run_amorphous_sweep(0, config, hooks=[SweepInfoPerFeatureHook(16, 1, persist=persist),
                                              _CrashAt(4)], checkpoint_dir=ckpt, **kwargs)
    assert DIBCheckpointer(ckpt).all_steps() == [2]
    hook = SweepInfoPerFeatureHook(16, 1, persist=persist, resume=True)
    result = run_amorphous_sweep(0, config, hooks=[hook], checkpoint_dir=ckpt, **kwargs)
    assert result["resumed_from_epoch"] == 2 and result["states"].epoch == 4
    for got, want in zip(result["records"], whole["records"]):
        for name in ("beta", "kl_per_feature", "loss", "val_loss", "metric", "val_metric"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)
    want_params = whole["states"].params.state_dict()
    for name, value in result["states"].params.state_dict().items():
        assert torch.equal(value, want_params[name]), name
    assert list(hook.epochs) == [2, 4]
    for got, want in zip(hook.records, whole_hook.records):
        np.testing.assert_array_equal(got["bounds"], want["bounds"])
