"""The port's event stream, trace context, spans and fit recorder against
the JAX package's.

The schema is the JAX package's kind for kind and field for field; the
port's streams read through the JAX ``read_events`` and are valid under the
JAX ``EVENT_SCHEMA`` (each record's kind known, its envelope and required
fields present) with ``DIB_TELEMETRY_STRICT=1``. Torn lines are skipped by
both readers alike, trace contexts cross the environment as the JAX
package's do, and ``python -m dib_tpu_torch train`` at its defaults writes
``events.jsonl`` into the run directory as the JAX ``train`` does (tiny
widths, 1 + 1 epochs of 2 steps, on the CPU).
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

import dib_tpu.telemetry.context as jax_context
import dib_tpu.telemetry.events as jax_events
from dib_tpu.telemetry.live import StreamFollower as JaxFollower
from dib_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from dib_tpu_torch import cli
from dib_tpu_torch.telemetry import context, events
from dib_tpu_torch.telemetry.hooks import ChunkPhaseHooks, FitRecorder
from dib_tpu_torch.telemetry.live import StreamFollower
from dib_tpu_torch.telemetry.metrics import MetricsRegistry, write_metrics
from dib_tpu_torch.telemetry.trace import SpannedHook, Tracer, span, use_tracer
from dib_tpu_torch.utils.profiling import PhaseTimer

TINY = ["--number_pretraining_epochs", "1", "--number_annealing_epochs", "1",
        "--batch_size", "64", "--steps_per_epoch", "2", "--feature_encoder_architecture", "8",
        "--integration_network_architecture", "16", "--feature_embedding_dimension", "4",
        "--max_val_points", "64"]


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("DIB_TELEMETRY_STRICT", "1")
    monkeypatch.setenv("DIB_HEARTBEAT_S", "0")


def _valid_under_jax(path):
    """The stream read by the JAX reader, every record valid under its schema."""
    read = list(jax_events.read_events(path))
    for event in read:
        assert events.validate_event(event, jax_events.EVENT_SCHEMA) == [], event
    return read


def test_the_schema_is_the_jax_schema():
    assert {k: (v.required, v.optional) for k, v in events.EVENT_SCHEMA.items()} == \
        {k: (v.required, v.optional) for k, v in jax_events.EVENT_SCHEMA.items()}
    assert events.ENVELOPE_FIELDS == jax_events.ENVELOPE_FIELDS
    assert events.REQUEST_PHASES == jax_events.REQUEST_PHASES
    assert events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION
    assert events.EVENTS_FILENAME == jax_events.EVENTS_FILENAME


def test_strict_mode_refuses_what_the_jax_writer_refuses(tmp_path):
    for writer in (events.EventWriter(str(tmp_path / "port")),
                   jax_events.EventWriter(str(tmp_path / "jax"), process_index=0)):
        with pytest.raises(ValueError, match="unknown event kind"):
            writer.emit("bogus")
        with pytest.raises(ValueError, match="REQUEST_PHASES"):
            writer.span(name="r", path="r", span_id=0, parent_id=None, seconds=0.1,
                        phases={"warp": 0.1})
        writer.close()
    assert events.validate_event({"type": "chunk", "v": 1}) != []


def test_concurrent_writers_and_torn_lines(tmp_path):
    """Threads share one writer (gapless seq, one line per event); a second
    writer appends to the same file; a torn line mid-file is skipped by
    both readers, with a warning."""
    writer = events.EventWriter(str(tmp_path), run_id="r1")
    threads = [threading.Thread(target=lambda: [writer.heartbeat(beat=i, epoch=0, phase="host")
                                                for i in range(50)]) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)           # switch threads as often as possible
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    with open(writer.path, "ab") as f:
        f.write(b'{"v": 1, "run": "r1", "type": "chu')          # a writer killed mid-append
    other = events.EventWriter(str(tmp_path), run_id="r1", tags={"src": "supervisor"})
    other.mitigation(mtype="crash_restart", launch=1)     # glued to the torn bytes: lost
    other.mitigation(mtype="stall_kill", launch=2, loss=float("nan"))
    other.close()
    writer.close()
    with pytest.warns(UserWarning, match="torn"):
        ours = list(events.read_events(str(tmp_path)))
    with pytest.warns(UserWarning, match="torn"):
        theirs = list(jax_events.read_events(str(tmp_path)))
    assert ours == theirs and len(ours) == 201
    assert sorted(e["seq"] for e in ours[:200]) == list(range(200))
    assert ours[-1]["loss"] == "NaN" and ours[-1]["tags"] == {"src": "supervisor"}
    assert ours[-1]["mtype"] == "stall_kill" and ours[-1]["seq"] == 1


def test_the_follower_reads_as_the_jax_follower(tmp_path):
    path = tmp_path / "events.jsonl"
    ours, theirs = StreamFollower(str(tmp_path)), JaxFollower(str(tmp_path))
    assert ours.poll() == theirs.poll() == []
    chunks = [b'{"type": "heartbeat", "beat": 1}\n{"type": "chu', b'nk", "epoch": 2}\n',
              b'not json\n{"type": "run_end"}\n']
    for chunk in chunks:
        with open(path, "ab") as f:
            f.write(chunk)
        assert ours.poll() == theirs.poll()
    assert ours.torn == theirs.torn == 1 and ours.events_read == theirs.events_read == 3


def test_trace_contexts_cross_the_environment_as_the_jax_ones(monkeypatch):
    for name in (context.TRACE_ENV, context.TRACE_PARENT_ENV, context.TRACE_ORIGIN_ENV):
        monkeypatch.delenv(name, raising=False)
    assert context.from_env() is None and jax_context.from_env() is None
    root = context.mint("train", trace_id="trace-abc")
    root.child("run:r1", origin="watchdog").activate()
    got, want = context.from_env(), jax_context.from_env()
    assert got.to_dict() == want.to_dict() == {"trace_id": "trace-abc", "parent": "run:r1",
                                               "origin": ["train", "watchdog"]}
    assert context.ensure_context("worker").to_dict() == \
        jax_context.ensure_context("worker").to_dict()
    assert context.ensure_context("x", trace_id="t2").to_dict() == \
        jax_context.ensure_context("x", trace_id="t2").to_dict()
    assert context.child_context(None, "run:r") is None


def test_run_ids_and_the_telemetry_dir_convention(tmp_path, monkeypatch):
    monkeypatch.setenv("DIB_TELEMETRY_RUN_ID", "pinned")
    assert events.shared_run_id() == jax_events.shared_run_id() == "pinned"
    monkeypatch.delenv("DIB_TELEMETRY_RUN_ID")
    assert events.shared_run_id() != events.shared_run_id()
    assert events.open_writer("", str(tmp_path)) is None
    assert events.open_writer(None, None) is None
    writer = events.open_writer(None, str(tmp_path / "run"), run_id="r")
    assert writer.path == str(tmp_path / "run" / "events.jsonl")
    writer.close()
    manifest = events.runtime_manifest(config={"a": 1}, device_info=False)
    assert manifest["config_hash"] == jax_events.config_fingerprint({"a": 1})
    assert "torch" in manifest["versions"] and "jax" not in manifest["versions"]
    assert events.runtime_manifest()["device_platform"] in ("cpu", "gpu")


def test_phase_timer_reports_as_the_jax_timer():
    ours, theirs = PhaseTimer(), JaxPhaseTimer()
    for name, seconds in (("chunk", 0.5), ("hook", 0.25), ("chunk", 1.5)):
        ours.add(name, seconds)
        theirs.add(name, seconds)
    assert ours.report() == theirs.report() and ours.intervals == theirs.intervals
    with ours.phase("wait") as handle:
        handle.block_on(np.zeros(3))
    assert ours.counts["wait"] == 1


def test_spans_nest_and_land_on_the_stream(tmp_path):
    writer = events.EventWriter(str(tmp_path))
    tracer = Tracer(writer)
    with use_tracer(tracer):
        with span("fit", epoch=0):
            with span("chunk") as handle:
                handle.annotate(epoch=1)
            token = tracer.begin("instrumentation")
            SpannedHook("mi", lambda trainer, state, epoch: None)(None, None, 1)

            class Quiet:
                def fires_at(self, epoch):
                    return False

                def __call__(self, trainer, state, epoch):
                    raise AssertionError("a skipped epoch runs no hook")

            SpannedHook("skipped", Quiet())(None, None, 1)
            tracer.end(token)
    writer.close()
    spans = [e for e in _valid_under_jax(str(tmp_path)) if e["type"] == "span"]
    assert [(s["path"], s["parent"]) for s in spans] == [
        ("fit/chunk", 0), ("fit/instrumentation/mi", 2), ("fit/instrumentation", 0),
        ("fit", None)]
    assert spans[0]["epoch"] == 1 and set(tracer.timer.totals) == {s["path"] for s in spans}


def test_the_recorder_beats_from_its_thread_during_a_chunk(tmp_path):
    writer = events.EventWriter(str(tmp_path))
    recorder = FitRecorder(writer, steps_per_epoch=4)
    with recorder.heartbeats(interval_s=0.02):
        with recorder.chunk_phase() as phase:
            phase.block_on(np.zeros(1))
            time.sleep(0.3)
        recorder.record_chunk(epoch=1, chunk_epochs=1, beta=0.1, loss=1.0, val_loss=1.0,
                              kl_per_feature=[0.5])
        time.sleep(0.3)
    recorder.finish()
    writer.close()
    stream = _valid_under_jax(str(tmp_path))
    beats = [e for e in stream if e["type"] == "heartbeat"]
    assert {b["phase"] for b in beats} == {"chunk", "boundary", "host"}
    assert [b["beat"] for b in beats] == sorted(b["beat"] for b in beats)
    assert all(b["phase_elapsed_s"] > 0 for b in beats if b["phase"] == "chunk")
    chunk = next(e for e in stream if e["type"] == "chunk")
    assert chunk["steps"] == 4 and chunk["seconds"] >= 0.3 and chunk["host_memory"]
    assert stream[-1]["type"] == "metrics" and stream[-1]["snapshots"][0]["proc"] == 0
    assert FitRecorder(None, steps_per_epoch=1).chunk_phase().__enter__() is not None


def test_chunk_phase_hooks_split_the_boundary(tmp_path):
    writer = events.EventWriter(str(tmp_path))
    phases = ChunkPhaseHooks(telemetry=writer, steps_per_epoch=3, tracer=Tracer(writer))
    phases.start()
    for epoch in (2, 4):
        phases.pre(None, {"w": np.zeros(2)}, epoch)
        phases.post(None, None, epoch)
    writer.close()
    kinds = [(e["type"], e.get("name") or e.get("epoch")) for e in _valid_under_jax(
        str(tmp_path))]
    assert kinds == [("span", "chunk"), ("chunk", 2), ("span", "instrumentation"),
                     ("hook", "checkpoint_instrumentation"), ("span", "chunk"), ("chunk", 4),
                     ("span", "instrumentation"), ("hook", "checkpoint_instrumentation")]
    assert len(phases.timer.intervals["chunk"]) == 2


def test_write_metrics_writes_one_event(tmp_path):
    registry = MetricsRegistry()
    registry.counter("steps").inc(3)
    writer = events.EventWriter(str(tmp_path))
    assert write_metrics(registry, writer)
    writer.close()
    (event,) = _valid_under_jax(str(tmp_path))
    assert event["snapshots"] == [{"proc": 0, "counters.steps": 3.0}]


@pytest.mark.parametrize("extra", [[], ["--sweep_beta_ends", "0.1", "1.0"]])
def test_train_at_its_defaults_writes_the_event_stream(tmp_path, extra):
    argv = ["train", "--artifact_outdir", str(tmp_path), *TINY, "--checkpoint_dir",
            str(tmp_path / "ckpt"), "--checkpoint_frequency", "1", *extra]
    assert cli.main(argv, device="cpu") == 0
    stream = _valid_under_jax(str(tmp_path))
    kinds = [e["type"] for e in stream]
    assert kinds == ["run_start", "span", "chunk", "heartbeat", "span", "chunk", "heartbeat",
                     "metrics", "run_end"]
    manifest = stream[0]["manifest"]
    assert manifest["dataset"] == "boolean_circuit" and manifest["device_platform"] == "cpu"
    assert len({e["run"] for e in stream}) == 1 and stream[-1]["status"] == "ok"
    chunk = stream[2]
    if extra:
        assert np.shape(chunk["loss"]) == (2,) and chunk["beta_ends"] == [0.1, 1.0]
        assert manifest["beta_ends"] == [0.1, 1.0]
    else:
        assert isinstance(chunk["loss"], float) and len(chunk["kl_per_feature"]) == 10
    with open(tmp_path / "run_summary.json") as f:
        assert json.load(f)["events_path"] == str(tmp_path / "events.jsonl")


def test_an_empty_telemetry_dir_writes_no_stream(tmp_path):
    argv = ["train", "--artifact_outdir", str(tmp_path / "run"), *TINY,
            "--telemetry-dir", "", "--preempt_grace_s", "0"]
    assert cli.main(argv, device="cpu") == 0
    assert not os.path.exists(tmp_path / "run" / "events.jsonl")
    argv[argv.index("")] = str(tmp_path / "elsewhere")
    assert cli.main(argv, device="cpu") == 0
    assert [e["type"] for e in _valid_under_jax(str(tmp_path / "elsewhere"))][-1] == "run_end"


def test_a_crashed_run_ends_its_stream_with_an_error(tmp_path, monkeypatch):
    import dib_tpu_torch.train.loop as loop

    def crash(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(loop.DIBTrainer, "run_chunk", crash)
    with pytest.raises(RuntimeError, match="device lost"):
        cli.main(["train", "--artifact_outdir", str(tmp_path), *TINY], device="cpu")
    stream = _valid_under_jax(str(tmp_path))
    assert stream[-1]["type"] == "run_end" and stream[-1]["status"] == "error"
    assert "device lost" in stream[-1]["error"]


def test_a_workload_brackets_its_run(tmp_path, monkeypatch):
    from dib_tpu_torch import workloads

    monkeypatch.setattr(workloads, "run_amorphous_workload", lambda *a, **k: {"done": True})
    assert cli.main(["workload", "amorphous", "--outdir", str(tmp_path), "--set",
                     "num_steps=2"], device="cpu") == 0
    stream = _valid_under_jax(str(tmp_path))
    assert [e["type"] for e in stream] == ["run_start", "run_end"]
    assert stream[0]["manifest"]["workload"] == "amorphous"
    assert stream[0]["manifest"]["config"]["num_steps"] == 2
