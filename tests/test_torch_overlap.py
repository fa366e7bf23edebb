"""Overlapped MI measurement, the hooks' event stream and their rewind.

``overlap=True`` files the same numbers as ``overlap=False`` (the serial
and the sweep hook, through a fit), one boundary later or at the first
read of ``records``, and accounts for its wait as the JAX package's
``collect_overlapped`` does: one ``mi_bounds`` span with
``overlapped=True``, ``seconds`` the exposed wait and ``queued_s`` the
dispatch-to-ready window. The snapshot is a copy the next chunk's updates
do not reach. After a rollback to a checkpoint older than the hook's last
call, the hooks rewind, so the rolled-back run measures what the
uninterrupted one measured, bit for bit. On the CPU the measurement runs
at once; the side CUDA stream is held to the same stream in
``tests/test_torch_cuda.py`` and in ``chip_smoke.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from dib_tpu.telemetry.events import EVENT_SCHEMA as JAX_SCHEMA
from dib_tpu.telemetry.trace import Tracer as JaxTracer
from dib_tpu.train.overlap import PendingDispatch as JaxPending
from dib_tpu.train.overlap import collect_overlapped as jax_collect
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.faults import FaultPlan
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.parallel import BetaSweepTrainer, SweepInfoPerFeatureHook, member_seed
from dib_tpu_torch.telemetry import EventWriter, read_events, validate_event
from dib_tpu_torch.telemetry.trace import Tracer
from dib_tpu_torch.train import (
    CheckpointHook,
    DIBCheckpointer,
    DIBTrainer,
    Every,
    InfoPerFeatureHook,
    TrainConfig,
)
from dib_tpu_torch.train.overlap import OverlapRunner, PendingDispatch, collect_overlapped

torch.set_num_threads(1)

SETTINGS = dict(learning_rate=1e-3, batch_size=8, num_pretraining_epochs=2,
                num_annealing_epochs=2, steps_per_epoch=2, max_val_points=64)
DIB = dict(encoder_hidden=(8,), integration_hidden=(8,), output_dim=1, embedding_dim=4)


@pytest.fixture(scope="module")
def bundle():
    return get_dataset("boolean_circuit")


def _model(bundle, replicas=None):
    generator = (torch.Generator().manual_seed(0) if replicas is None else
                 [torch.Generator().manual_seed(member_seed(0, r)) for r in range(replicas)])
    return DistributedIBModel(tuple(bundle.feature_dimensionalities), **DIB, device="cpu",
                              generator=generator, replicas=replicas)


def _serial_fit(bundle, hook, hooks=(), plan=None, tmp=None):
    trainer = DIBTrainer(_model(bundle), bundle, TrainConfig(**SETTINGS), device="cpu")
    writer = None if tmp is None else EventWriter(str(tmp))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, history = trainer.fit(torch.Generator().manual_seed(1), hooks=[hook, *hooks],
                                 hook_every=1, telemetry=writer,
                                 fault_plan=FaultPlan.parse(plan) if plan else None)
    if writer is not None:
        writer.close()
    return history


def test_the_overlapped_serial_hook_files_the_same_bounds(bundle, tmp_path):
    plain, overlapped = InfoPerFeatureHook(16, 2), InfoPerFeatureHook(16, 2, overlap=True)
    want = _serial_fit(bundle, plain)
    writer = EventWriter(str(tmp_path))
    overlapped.telemetry = writer
    got = _serial_fit(bundle, overlapped, tmp=tmp_path / "fit")
    assert overlapped._pending is not None            # the last call waits for a read
    assert overlapped.records == plain.records and len(plain.records) == 4
    assert overlapped._pending is None
    np.testing.assert_array_equal(got.loss, want.loss)
    writer.close()
    bounds = list(read_events(str(tmp_path)))
    assert [e["epoch"] for e in bounds] == [1, 2, 3, 4]
    assert all(validate_event(e, JAX_SCHEMA) == [] for e in bounds)
    np.testing.assert_allclose(bounds[0]["lower_bits"],
                               np.asarray(plain.records[0]["bounds"])[:, 0] / np.log(2))
    spans = [e for e in read_events(str(tmp_path / "fit")) if e["type"] == "span"
             and e["name"] == "mi_bounds"]
    assert [s["epoch"] for s in spans] == [1, 2, 3] and all(s["overlapped"] for s in spans)


def test_the_overlapped_sweep_hook_files_the_same_bounds(bundle, tmp_path):
    records = {}
    for overlap in (False, True):
        hook = SweepInfoPerFeatureHook(16, 2, overlap=overlap,
                                       persist=str(tmp_path / str(overlap)))
        sweep = BetaSweepTrainer(_model(bundle, 2), bundle, TrainConfig(**SETTINGS), 1e-4,
                                 [0.1, 1.0], device="cpu")
        sweep.fit([torch.Generator().manual_seed(r) for r in range(2)], hooks=[hook],
                  hook_every=1)
        records[overlap] = hook.records
    assert len(records[True]) == 4
    for got, want in zip(records[True], records[False]):
        assert got["epoch"] == want["epoch"] and np.array_equal(got["bounds"], want["bounds"])
    with np.load(tmp_path / "True" / "epoch4.npz") as mirrored:
        assert np.array_equal(mirrored["bounds"], records[False][-1]["bounds"])


def test_the_wait_is_accounted_as_the_jax_package_accounts_it():
    ours, theirs = Tracer(), JaxTracer()
    for tracer, pending, collect in (
            (ours, PendingDispatch(outputs=[torch.ones(2)], meta={"epoch": 3}, token=0.0),
             collect_overlapped),
            (theirs, JaxPending(outputs={"x": np.ones(2)}, meta={"epoch": 3}, token=0.0),
             jax_collect)):
        pending.tracer = tracer
        collect(pending)
    assert ours.timer.counts == theirs.timer.counts == {"mi_bounds": 1}


def test_the_snapshot_is_not_reached_by_later_updates(bundle):
    model = _model(bundle)
    runner = OverlapRunner()
    shadow = runner.snapshot(model)
    assert shadow is not model and runner.snapshot(model) is shadow
    before = [p.detach().clone() for p in shadow.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(before, shadow.parameters()))
    runner.snapshot(model)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), shadow.parameters()))
    pending = runner.launch(lambda: (torch.ones(3),), torch.device("cpu"), epoch=1)
    assert pending.event is None and runner.last_stream is None


@pytest.mark.parametrize("overlap", [False, True])
def test_a_rollback_rewinds_the_hooks(bundle, tmp_path, overlap):
    """The MI hook every chunk, checkpoints every second chunk: the
    rollback after ``nan@chunk3`` goes back past a hook call, and the
    replay measures what the uninterrupted run measured."""
    def run(plan, directory):
        hook = InfoPerFeatureHook(16, 2, overlap=overlap)
        ckpt = Every(2, CheckpointHook(DIBCheckpointer(str(directory))))
        history = _serial_fit(bundle, hook, hooks=[ckpt], plan=plan)
        return history, hook

    want_history, want = run(None, tmp_path / "clean")
    got_history, got = run("nan@chunk3", tmp_path / "fault")
    assert got.records == want.records and [r["epoch"] for r in got.records] == [1, 2, 3, 4]
    np.testing.assert_array_equal(got_history.loss, want_history.loss)


def test_the_sweep_hook_rewinds_to_an_epoch(bundle):
    hook = SweepInfoPerFeatureHook(16, 2)
    sweep = BetaSweepTrainer(_model(bundle, 2), bundle, TrainConfig(**SETTINGS), 1e-4,
                             [0.1, 1.0], device="cpu")
    states, _ = sweep.fit([torch.Generator().manual_seed(r) for r in range(2)], hooks=[hook],
                          hook_every=1, num_epochs=3)
    first = [r["bounds"] for r in hook.records]
    hook.rewind(1)
    assert hook.epochs.tolist() == [1]
    for epoch in (2, 3):
        hook(sweep, states, epoch)
    # the third call draws as the third call did: on the same (final) weights
    # it measures the same bounds
    assert hook.epochs.tolist() == [1, 2, 3]
    assert np.array_equal(hook.records[2]["bounds"], first[2])
