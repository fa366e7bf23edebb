"""The port's readers of the event stream against the JAX package's.

Four streams: one the port's ``DIBServer`` wrote (ok answers, a 429, a
replica ejected and re-admitted, the metrics rollup); one a port training
fit wrote on the CPU with the fault plan ``nan@chunk2`` (rolled back to a
checkpoint) and an overlapped MI hook, so its ``faults`` and ``overlap``
blocks are not empty; one written with the JAX package's ``EventWriter``
that holds scheduler, stream, study, autopilot, breaker, integrity, mesh,
heartbeat, SLO and ``compile`` events, so every rollup runs; and the serve
stream with a torn last line. On each, the port's ``summarize`` must equal
``dib_tpu.telemetry.summary.summarize``, but for the JAX record's
``utilization`` block and its ``mfu`` alias (the port writes no
``compile`` event and carries no TPU peak table). ``compare`` must give
the same report and exit code on a pair that regresses and on one that
does not; ``render_report`` and ``render_index`` the same HTML once the
port's three passages that name its own tracing and package are mapped to
the JAX ones (``PROSE``); and the registry's entries must cross-validate
with ``validate_index_entry`` both ways. Everything here is file analysis:
the only model is the serve stream's, at the tiny width of
``tests/test_torch_serve_http.py``.
"""

import json
import os
import shutil
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from dib_tpu.telemetry import EventWriter as JaxWriter
from dib_tpu.telemetry import registry as jax_registry
from dib_tpu.telemetry import report as jax_report
from dib_tpu.telemetry import summary as jax_summary
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.faults import FaultPlan, FlakyEngine
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.serve import (
    DIBServer,
    InferenceEngine,
    MicroBatcher,
    ReplicaEntry,
    ReplicaRouter,
    TenantQuotas,
)
from dib_tpu_torch.telemetry import EventWriter, MetricsRegistry, read_events
from dib_tpu_torch.telemetry import registry, report, summary
from dib_tpu_torch.telemetry.trace import Tracer
from dib_tpu_torch.train import (
    CheckpointHook,
    DIBCheckpointer,
    DIBTrainer,
    Every,
    InfoPerFeatureHook,
    TrainConfig,
)

torch.set_num_threads(1)

CONFIG = dict(encoder_hidden=(8,), integration_hidden=(16,), output_dim=1, embedding_dim=2)
SETTINGS = dict(learning_rate=1e-3, batch_size=8, num_pretraining_epochs=2,
                num_annealing_epochs=3, steps_per_epoch=2, max_val_points=64)
# the port's report names its own tracing and package where the JAX one
# names XLA, jax.profiler and dib_tpu: port sentence -> JAX sentence
PROSE = {
    ("No cost-analysis numbers on this stream (the port writes no <code>compile</code> "
     "events) — spans above carry the duration-only view."):
        ("No XLA cost-analysis numbers on this stream (backend without a cost model, or "
         "<code>DIB_XLA_COST_ANALYSIS=0</code>) — spans above carry the duration-only view."),
    "The same names appear in captured CUDA traces\nas NVTX ranges.":
        ("The same names appear in captured XLA traces\n"
         "via <code>jax.profiler.TraceAnnotation</code>."),
    "(<code>dib_tpu_torch/faults</code>)": "(<code>dib_tpu/faults</code>)",
}
JAX_ONLY = ("utilization", "mfu")


# ---------------------------------------------------------------- streams

@pytest.fixture(scope="module")
def serve_dir(tmp_path_factory):
    """A port serving run: two replicas over one engine, replica 1 failed
    until ejected and re-admitted by a probe, a 429, then ``close()``."""
    directory = tmp_path_factory.mktemp("serve")
    bundle = get_dataset("boolean_circuit")
    rows = np.asarray(bundle.x_valid[:8], np.float32)
    writer = EventWriter(str(directory))
    writer.run_start({"mode": "serve", "device_kind": "cpu"})
    metrics_registry, tracer = MetricsRegistry(), Tracer(writer)
    model = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, batch_buckets=(1, 8), device="cpu")
    flaky = FlakyEngine(engine, telemetry=writer, replica=1)
    entries = [ReplicaEntry(eng, MicroBatcher(eng, max_batch=8, max_wait_ms=1.0, tracer=tracer,
                                              registry=metrics_registry), i)
               for i, eng in enumerate((engine, flaky))]
    router = ReplicaRouter(entries, eject_after=1, probe_after_s=0.0, telemetry=writer,
                           registry=metrics_registry)
    server = DIBServer(router, telemetry=writer, registry=metrics_registry, tracer=tracer,
                       quotas=TenantQuotas(0.0, overrides={"greedy": (1e-3, 1.0)})).start()
    try:
        for i in range(6):
            if i == 3:
                flaky.fail_next = 2
            headers = {"X-DIB-Tenant": "greedy"} if i in (4, 5) else {}
            request = urllib.request.Request(
                server.url + "/v1/predict", data=json.dumps({"x": rows[:i + 1].tolist()}).encode(),
                headers={"Content-Type": "application/json", **headers})
            try:
                urllib.request.urlopen(request, timeout=30).read()
            except urllib.error.HTTPError as exc:
                exc.read()
        assert router.probe_ejected(force=True) == 1
        end = time.monotonic() + 20     # the last request span follows the socket write
        while sum(e.get("name") == "request" for e in read_events(str(directory))) < 6:
            assert time.monotonic() < end
            time.sleep(0.01)
    finally:
        server.close()
    return str(directory)


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    """A port fit on the CPU: ``nan@chunk2`` rolled back to the checkpoint
    of epoch 1, an overlapped MI hook writing its spans and bounds."""
    directory = tmp_path_factory.mktemp("train")
    bundle = get_dataset("boolean_circuit")
    writer = EventWriter(str(directory))
    writer.run_start({"dataset": "boolean_circuit", "device_kind": "cpu"})
    trainer = DIBTrainer(DistributedIBModel(bundle.feature_dimensionalities, **CONFIG,
                                            device="cpu",
                                            generator=torch.Generator().manual_seed(0)),
                         bundle, TrainConfig(**SETTINGS), device="cpu")
    hook = InfoPerFeatureHook(16, 1, overlap=True)
    hook.telemetry = writer
    ckpt = DIBCheckpointer(str(directory / "ckpt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer.fit(torch.Generator().manual_seed(1), hooks=[hook, CheckpointHook(ckpt)],
                    hook_every=1, telemetry=writer, fault_plan=FaultPlan.parse("nan@chunk2"))
    hook.records    # the last overlapped measurement lands
    writer.run_end(status="ok")
    writer.close()
    return str(directory)


@pytest.fixture(scope="module")
def rollups_dir(tmp_path_factory):
    """Every kind the rollups read, written by the JAX package's writer."""
    directory = tmp_path_factory.mktemp("rollups")
    w = JaxWriter(str(directory))
    w.run_start({"mode": "sweep", "mesh_shape": {"sweep": 2, "data": 1},
                 "sweep_engine": "shard_map", "device_kind": "TPU v5 lite", "config_hash": "h"})
    w.compile(name="run_chunk", seconds=1.5, cache="cold", flops=1e9, bytes_accessed=1e6)
    for epoch in (1, 2, 3):
        w.chunk(epoch=epoch, steps=4, seconds=0.5 + 0.1 * epoch, loss=[0.5, 0.4],
                val_loss=[0.6, 0.5], beta=[0.1, 1.0], kl_per_feature=[[0.1, 0.2], [0.3, 0.4]],
                memory={"peak_bytes_in_use": 1000 * epoch},
                host_memory={"rss_bytes": 2000})
        w.span(name="chunk", path="sweep/chunk", span_id=epoch, parent_id=None, seconds=0.5)
        w.span(name="mi_bounds", path=f"sweep/replica{epoch}/mi_bounds", span_id=10 + epoch,
               parent_id=epoch, seconds=0.1, overlapped=True, queued_s=0.3)
        w.heartbeat(beat=epoch, epoch=epoch, phase="boundary", interval_s=1.0)
        w.hook(name="mi", epoch=epoch, seconds=0.05)
    w.mi_bounds(epoch=3, lower_nats=[0.5, 0.7], upper_nats=[0.9, 1.1])
    w.fault(kind="sched_worker_kill", unit="u1")
    w.job(job_id="j1", action="submitted", units=3, tenant="a")
    w.job(job_id="j2", action="submitted", units=2, tenant="b")
    w.job(job_id="j2", action="rejected", tenant="b")
    w.lease(unit="u1", action="granted", queue_wait_s=0.5, tenant="a")
    w.lease(unit="u2", action="granted", queue_wait_s=2.5, tenant="b")
    w.lease(unit="u1", action="expired")
    w.mitigation(mtype="worker_dead", unit="u1")
    w.lease(unit="u1", action="stolen")
    w.job(job_id="j1", action="unit_failed", retries=1, tenant="a")
    w.job(job_id="j1", action="unit_done", tenant="a")
    w.job(job_id="j1", action="done")
    w.publish(publish_id="p0", step=10, index=0)
    w.drift(round=1, detector="kl")
    w.deploy(publish_id="p0", action="promoted", latency_s=1.25, index=0)
    w.deploy(publish_id="p1", action="rolled_back", latency_s=2.0, index=2)
    w.study(study_id="s1", action="submit", units=4)
    w.study(study_id="s1", action="round", estimates=[0.1], deltas_decades=[0.02],
            band_nats=0.3, budget_spent=4, budget_max=8, max_rounds=1)
    w.study(study_id="s1", action="round", estimates=[0.12])
    w.study(study_id="s1", action="unconverged")
    w.autopilot(action="intent", round=1)
    w.autopilot(action="intent", round=1)
    w.autopilot(action="submitted", round=1)
    w.autopilot(action="applied", round=1, drift_to_apply_s=12.5)
    w.autopilot(action="skip", round=2, reason="cooldown")
    w.breaker(action="trip")
    w.anomaly(epoch=2, channel="kl0", kind="spike")
    w.mitigation(mtype="anomaly_rollback", epoch=2)
    w.quarantine(step=2, reason="anomalous window")
    w.mitigation(mtype="sweep_reshard", saved_width=4, restored_width=2,
                 saved_mesh_axes={"sweep": 4}, mesh_axes={"sweep": 2})
    w.mitigation(mtype="member_backfill", replica=1)
    w.alert(rule="mfu_floor", metric="mfu", value=0.1, bound="min", budget=0.2)
    w.transition(channel=0, epoch=2, direction="down", kl_before=0.5, kl_after=0.1)
    w.metrics([{"proc": 0, "counters.train.steps": 12, "gauges.train.loss": 0.4}])
    w.run_end(status="ok")
    w.close()
    return str(directory)


@pytest.fixture(scope="module")
def torn_dir(serve_dir, tmp_path_factory):
    directory = tmp_path_factory.mktemp("torn")
    shutil.copy(os.path.join(serve_dir, "events.jsonl"), directory / "events.jsonl")
    with open(directory / "events.jsonl", "a") as f:
        f.write('{"v": 1, "run": "x", "type": "sp')
    return str(directory)


STREAMS = ("serve_dir", "train_dir", "rollups_dir", "torn_dir")


def _jax_record(path, run_id=None):
    """The JAX package's record without its ``utilization`` and ``mfu``."""
    record = jax_summary.summarize(path, run_id=run_id)
    for key in JAX_ONLY:
        record.pop(key, None)
    return record


# ----------------------------------------------------------------- summarize

@pytest.mark.parametrize("stream", STREAMS)
def test_summarize_matches_jax(stream, request):
    path = request.getfixturevalue(stream)
    if stream == "torn_dir":
        with pytest.warns(UserWarning, match="torn event line"):
            got = summary.summarize(path)
        with pytest.warns(UserWarning, match="torn event line"):
            want = _jax_record(path)
    else:
        got, want = summary.summarize(path), _jax_record(path)
    assert got == want
    assert "utilization" not in got and "mfu" not in got
    if stream in ("serve_dir", "torn_dir"):
        assert got["serving"]["requests"] == 6 and got["serving"]["statuses"] == {
            "ok": 5, "quota": 1}
        assert got["mitigations"] == {"replica_ejected": 1, "replica_readmitted": 1}
        assert got["faults"]["injected"] == 2 and got["faults"]["undetected"] == []
        assert got["metrics"]["counters.serve.requests.quota"] == 1
    if stream == "train_dir":
        assert got["faults"]["injected"] == 1 and got["faults"]["recovered"] == 1
        assert got["overlap"]["spans"] >= 3 and got["mitigations"]["divergence_rollback"] == 1
    if stream == "rollups_dir":
        assert "utilization" in jax_summary.summarize(path)      # what the port leaves out
        for block in ("scheduler", "streaming", "study", "autopilot", "integrity", "mesh",
                      "faults", "overlap", "heartbeats", "alerts", "transitions", "compile"):
            assert got.get(block), block


def test_summarize_restricts_to_one_run_and_refuses_a_non_stream(serve_dir, tmp_path):
    run_id = summary.summarize(serve_dir)["run_id"]
    assert summary.summarize(serve_dir, run_id=run_id) == _jax_record(serve_dir, run_id)
    (tmp_path / "events.jsonl").write_text('{"metric": "x"}\n')
    for module in (summary, jax_summary):
        with pytest.raises(ValueError, match="not a telemetry stream"):
            module.summarize(str(tmp_path))


# ------------------------------------------------------------------- compare

@pytest.mark.parametrize("regress", [False, True], ids=["steady", "regressed"])
def test_compare_matches_jax(train_dir, serve_dir, tmp_path, capsys, regress):
    """The same report and exit code from both packages' ``compare`` and
    ``telemetry compare``: a run against itself does not regress; a slower,
    lossier candidate with a serving phase 3x slower does."""
    for path in (train_dir, serve_dir):
        base = summary.summarize(path)
        cand = json.loads(json.dumps(base))
        if regress:
            cand["steps_per_s"] = (cand.get("steps_per_s") or 1.0) * 0.5
            cand["final_loss"] = 10.0
            for phase in (cand.get("serving") or {}).get("phases", {}).values():
                phase["p99_ms"] = phase["p99_ms"] * 3 + 1.0
        got = summary.compare(base, cand, threshold=0.05)
        assert got == jax_summary.compare(base, cand, threshold=0.05)
        assert got[1] is regress
        files = []
        for name, record in (("a", base), ("b", cand)):
            files.append(str(tmp_path / f"{name}.json"))
            with open(files[-1], "w") as f:
                json.dump(record, f)
        codes, outs = [], []
        for main in (summary.telemetry_main, jax_summary.telemetry_main):
            codes.append(main(["compare", *files, "--threshold", "0.05"]))
            outs.append(capsys.readouterr().out)
        assert codes == [int(regress)] * 2 and outs[0] == outs[1]
    assert summary.telemetry_main(["compare", str(tmp_path / "none"), files[0]]) == 2


# -------------------------------------------------------------------- report

def _mask(html_text: str) -> str:
    """Map the port's own sentences to the JAX ones (each must occur)."""
    for port_text, jax_text in PROSE.items():
        html_text = html_text.replace(port_text, jax_text)
    return html_text


@pytest.mark.parametrize("stream", ("serve_dir", "train_dir"))
def test_render_report_matches_jax(stream, request, tmp_path):
    path = request.getfixturevalue(stream)
    got = report.render_report(path)
    for port_text in list(PROSE)[:2]:
        assert port_text in got
    assert _mask(got) == jax_report.render_report(path)
    out = report.write_report(path, out=str(tmp_path / "report.html"))
    assert open(out).read() == got
    assert ("<svg" in got) is (stream == "train_dir")     # the training trajectory's charts


def test_render_report_of_every_rollup(rollups_dir):
    """The JAX stream's report differs only in its utilization table: the
    port's summary has none, so the port renders the duration-only note."""
    got = report.render_report(rollups_dir)
    want = jax_report.render_report(rollups_dir)
    head, _, _ = want.partition("<h2>Roofline utilization</h2>")
    assert _mask(got).startswith(head) and "<h2>Fault drills</h2>" in got
    assert "SLO alerts" in got and "mfu_floor" in got


# ------------------------------------------------------------------ registry

@pytest.fixture(scope="module")
def runs_root(serve_dir, train_dir, tmp_path_factory):
    """A runs root the port registered both runs and a bench record in."""
    root = str(tmp_path_factory.mktemp("runs"))
    for run_dir in (serve_dir, train_dir):
        assert registry.register_run(run_dir, root=root) is not None
    record = {"metric": "sweep_minutes", "value": 3.5, "unit": "minutes", "steps_per_s": 9.0,
              "device_kind": "NVIDIA H100", "measured_at": "2026-01-01T00:00:00Z"}
    registry.RunRegistry(root).append(registry.bench_entry(record))
    assert registry.register_drill_record({"metric": "drill", "value": 1.0, "total": 3,
                                           "all_passed": True}, root=root) is not None
    return root


def test_registry_entries_cross_validate(runs_root, serve_dir, train_dir, tmp_path):
    ours = registry.RunRegistry(runs_root).entries()
    assert len(ours) == 4
    for entry in ours:
        assert jax_registry.validate_index_entry(entry) == [], entry
        assert registry.validate_index_entry(entry) == []
    for run_dir in (serve_dir, train_dir):
        assert registry.run_entry(run_dir) == jax_registry.run_entry(run_dir)
    record = {"metric": "m", "value": 1.0, "telemetry": {"run_id": "r"}, "mfu": 0.3}
    assert registry.bench_entry(record) == jax_registry.bench_entry(record)
    theirs = jax_registry.RunRegistry(str(tmp_path))
    theirs.append(jax_registry.run_entry(serve_dir))
    theirs.append(jax_registry.bench_entry(record))
    for entry in registry.RunRegistry(str(tmp_path)).entries():
        assert registry.validate_index_entry(entry) == []
    assert registry.validate_index_entry({"v": 1, "t": 1.0, "kind": "x"}) == \
        jax_registry.validate_index_entry({"v": 1, "t": 1.0, "kind": "x"}) != []


def test_render_index_matches_jax(runs_root, serve_dir, tmp_path):
    report.write_report(serve_dir)         # the index links a run to its report
    got = report.render_index(runs_root)
    assert got == jax_report.render_index(runs_root)
    assert "sweep_minutes" not in got and "report.html" in got
    out = report.write_index(runs_root, out=str(tmp_path / "index.html"))
    assert open(out).read() == report.render_index(runs_root, out_dir=str(tmp_path))


@pytest.mark.parametrize("action", [["list"], ["show", "RUN"], ["show", "RUN", "--full-history"],
                                    ["trajectory"]])
def test_runs_subcommand_matches_jax(runs_root, serve_dir, capsys, action):
    run_id = summary.summarize(serve_dir)["run_id"]
    argv = ["runs", *[run_id if a == "RUN" else a for a in action], "--runs-root", runs_root]
    outputs = []
    for main in (summary.telemetry_main, jax_summary.telemetry_main):
        assert main(argv) == 0
        outputs.append(capsys.readouterr())
    assert outputs[0].out == outputs[1].out
    assert (run_id in outputs[0].out) is (action[0] != "trajectory")
    assert summary.telemetry_main(["runs", "show", "nope", "--runs-root", runs_root]) == 2


@pytest.mark.parametrize("action", ["tail", "check", "fleet"])
def test_the_dashboard_slo_and_fleet_actions_are_refused(capsys, action):
    assert summary.telemetry_main([action, "x"]) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP.md queue 1, item 6" in err
