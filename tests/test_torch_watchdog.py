"""The port's stall watchdog against the JAX package's.

``_steady_timeout`` makes the JAX supervisor's decisions on the same
intervals. ``supervise`` kills a stalled worker and relaunches it, restarts
a crashed one with the crash-loop backoff, relaunches a preempted one at
once, and reads liveness from the worker's event stream, as
``tests/test_watchdog.py`` holds the JAX supervisor. Its workers are Python
scripts that call ``cli.main(argv, device="cpu")`` (a crash loop: a refused
flag) or short scripts that beat and exit on cue. End to end, ``python -m
dib_tpu_torch train --watchdog`` with ``DIB_FAULT_PLAN=stall@chunk2:60s``
exits 0 after one stall kill, and its ``history.npz`` equals an
uninterrupted run's bit for bit (the card check adds a ``kill`` fault and
its crash restart, which costs one more CPU worker start here).
"""

import json
import os
import sys
import textwrap
import time

import numpy as np
import pytest

from dib_tpu.train.watchdog import WatchdogConfig as JaxConfig
from dib_tpu.train.watchdog import _steady_timeout as jax_steady_timeout
from dib_tpu_torch import cli
from dib_tpu_torch.telemetry import EventWriter, read_events, validate_event
from dib_tpu_torch.train.watchdog import (
    PREEMPT_EXIT_CODE,
    HeartbeatHook,
    WatchdogConfig,
    _steady_timeout,
    supervise,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = dict(poll_s=0.05, max_restarts=2)


@pytest.mark.parametrize("intervals", [[], [30.0], [30.0, 1.0], [30.0, 1.0, 2.0, 1.5],
                                       [5.0] + [0.2] * 40, [100.0, 20.0, 20.0, 40.0]])
@pytest.mark.parametrize("floor_s,k", [(45.0, 3.0), (1.0, 3.0), (5.0, 10.0)])
def test_the_steady_timeout_is_the_jax_one(intervals, floor_s, k):
    assert _steady_timeout(intervals, WatchdogConfig(floor_s=floor_s, k=k)) == \
        jax_steady_timeout(intervals, JaxConfig(floor_s=floor_s, k=k))


def _worker(tmp_path, body: str) -> list:
    path = tmp_path / "worker.py"
    path.write_text(textwrap.dedent(body))
    return [sys.executable, str(path)]


def test_a_stalled_worker_is_killed_and_relaunched(tmp_path):
    hb, marker = str(tmp_path / "hb.json"), str(tmp_path / "stalled_once")
    cmd = _worker(tmp_path, f"""
        import json, os, time
        hb, marker = {hb!r}, {marker!r}
        def beat(n):
            with open(hb + ".tmp", "w") as f:
                json.dump({{"epoch": n, "beat": n, "time": time.time(),
                           "intervals_s": [0.2] * n}}, f)
            os.replace(hb + ".tmp", hb)
        for n in range(1, 3):
            time.sleep(0.2); beat(n)
        if not os.path.exists(marker):
            open(marker, "w").close()
            time.sleep(600)
        for n in range(3, 6):
            time.sleep(0.2); beat(n)
    """)
    t0 = time.time()
    result = supervise(cmd, hb, WatchdogConfig(first_beat_timeout_s=60.0, floor_s=2.0, **FAST))
    assert result["returncode"] == 0 and result["launches"] == 2
    assert [m["type"] for m in result["mitigations"]] == ["stall_kill"]
    assert result["mitigations"][0]["beats"] == 2 and time.time() - t0 < 30


def test_a_crash_loop_backs_off_then_gives_up(tmp_path):
    """A worker that dies at once (the CLI refusing a flag) is relaunched
    with a backoff that grows with each quick death, then given up on."""
    hb = str(tmp_path / "hb.json")
    cmd = [*cli._entry_command("cpu"), "train", "--mesh_data", "2"]
    t0 = time.time()
    result = supervise(cmd, hb, WatchdogConfig(restart_backoff_s=0.2, min_uptime_s=30.0,
                                               **FAST), env={**os.environ, "PYTHONPATH": REPO})
    assert result["returncode"] == 2 and result["launches"] == 3 and "error" in result
    assert [m["type"] for m in result["mitigations"]] == ["crash_restart"] * 3
    assert time.time() - t0 >= 0.2 + 0.4          # backoff x consecutive quick deaths


def test_a_crash_and_a_preemption_are_relaunched(tmp_path):
    hb, count = str(tmp_path / "hb.json"), str(tmp_path / "launches")
    cmd = _worker(tmp_path, f"""
        import json, os, sys, time
        path = {count!r}
        n = int(open(path).read()) + 1 if os.path.exists(path) else 1
        open(path, "w").write(str(n))
        with open({hb!r}, "w") as f:
            json.dump({{"epoch": n, "beat": 1, "time": time.time(), "intervals_s": [0.1]}}, f)
        sys.exit({{1: 3, 2: {PREEMPT_EXIT_CODE}, 3: {PREEMPT_EXIT_CODE}}}.get(n, 0))
    """)
    result = supervise(cmd, hb, WatchdogConfig(max_restarts=1, poll_s=0.05))
    assert result["returncode"] == 0 and result["launches"] == 4
    assert [m["type"] for m in result["mitigations"]] == ["crash_restart", "preempt_restart",
                                                          "preempt_restart"]
    assert [m.get("epoch") for m in result["mitigations"]][1:] == [2, 3]


def test_liveness_comes_from_the_event_stream(tmp_path):
    """Boundary beats on events.jsonl drive the stall clock; the kill record
    carries how long ago any beat landed, and lands on the same stream."""
    marker = str(tmp_path / "stalled_once")
    cmd = _worker(tmp_path, f"""
        import os, sys, time
        sys.path.insert(0, {REPO!r})
        from dib_tpu_torch.telemetry.events import EventWriter
        writer = EventWriter({str(tmp_path)!r})
        for n in range(1, 3):
            time.sleep(0.2)
            writer.heartbeat(beat=n, epoch=n, phase="boundary", intervals_s=[0.2] * n)
        if not os.path.exists({marker!r}):
            open({marker!r}, "w").close()
            writer.heartbeat(beat=3, epoch=2, phase="chunk", interval_s=0.2)
            time.sleep(600)
        writer.heartbeat(beat=3, epoch=3, phase="boundary", intervals_s=[0.2] * 3)
    """)
    supervisor = EventWriter(str(tmp_path), tags={"src": "supervisor"})
    result = supervise(cmd, str(tmp_path / "unused.json"),
                       WatchdogConfig(first_beat_timeout_s=60.0, floor_s=2.0, **FAST),
                       telemetry=supervisor, events_path=supervisor.path)
    supervisor.close()
    assert result["returncode"] == 0 and result["launches"] == 2
    (kill,) = result["mitigations"]
    assert kill["type"] == "stall_kill" and kill["epoch"] == 2 and kill["worker_alive_s"] >= 1
    mitigations = [e for e in read_events(str(tmp_path)) if e["type"] == "mitigation"]
    assert [(m["mtype"], m["tags"]) for m in mitigations] == [("stall_kill",
                                                              {"src": "supervisor"})]


def test_the_heartbeat_hook_writes_atomic_beats(tmp_path):
    hb = str(tmp_path / "hb.json")
    hook = HeartbeatHook(hb)

    class State:
        params = {"w": np.zeros(3)}

    hook(None, State(), 2)
    time.sleep(0.05)
    hook(None, State(), 4)
    with open(hb) as f:
        beat = json.load(f)
    assert beat["beat"] == 2 and beat["epoch"] == 4 and beat["intervals_s"][1] >= 0.05


# ------------------------------------------------------------ end to end

TINY = ["--number_pretraining_epochs", "1", "--number_annealing_epochs", "2",
        "--batch_size", "64", "--steps_per_epoch", "2", "--feature_encoder_architecture", "8",
        "--integration_network_architecture", "16", "--feature_embedding_dimension", "4",
        "--max_val_points", "64", "--checkpoint_frequency", "1"]


def test_train_under_the_watchdog_survives_a_stall(tmp_path, monkeypatch, capsys):
    for name in ("DIB_TELEMETRY_RUN_ID", "DIB_TRACE_ID", "DIB_TRACE_PARENT",
                 "DIB_TRACE_ORIGIN"):
        monkeypatch.delenv(name, raising=False)
    whole, run = tmp_path / "whole", tmp_path / "run"
    assert cli.main(["train", "--artifact_outdir", str(whole), "--checkpoint_dir",
                     str(whole / "ckpt"), *TINY], device="cpu") == 0
    monkeypatch.setenv("DIB_FAULT_PLAN", "stall@chunk2:60s")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    capsys.readouterr()
    t0 = time.time()
    # the floor outlasts the worker's work after its last boundary (drawing
    # the info plane), which beats nothing, with room for a loaded machine
    assert cli.main(["train", "--artifact_outdir", str(run), *TINY, "--watchdog",
                     "--watchdog_floor_s", "10"], device="cpu") == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["watchdog"]
    assert time.time() - t0 < 240             # the 60 s stall is not waited out
    assert report["returncode"] == 0 and report["launches"] == 2
    assert [m["type"] for m in report["mitigations"]] == ["stall_kill"]
    assert report["mitigations"][0]["epoch"] == 2 and report["mitigations"][0]["beats"] == 2
    assert report["checkpoint_dir"] == str(run / "ckpt")
    with np.load(run / "history.npz") as got, np.load(whole / "history.npz") as want:
        for name in want.files:
            assert np.array_equal(got[name], want[name]), name
    stream = list(read_events(str(run)))
    assert all(validate_event(e) == [] for e in stream) and len({e["run"] for e in stream}) == 1
    assert [e["kind"] for e in stream if e["type"] == "fault"] == ["stall"]
    assert [(e["mtype"], e.get("tags")) for e in stream if e["type"] == "mitigation"] == [
        ("stall_kill", {"src": "supervisor"})]
    assert [e["type"] for e in stream].count("run_start") == 2
    assert stream[-1]["type"] == "run_end" and stream[-1]["resumed_from_epoch"] == 2
