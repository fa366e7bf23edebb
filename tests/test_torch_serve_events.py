"""The port's serving event stream against the JAX package's, on one script.

Both servers run in this process on ephemeral ports over the same weights
(a tiny boolean-circuit model: encoders (8,), integration (16,), embedding
2, buckets (1, 8), carried into the port with ``interop.params_from_flax``),
each with two replicas over one engine, replica 1 behind a ``FlakyEngine``,
and each writing its stream into a directory of its own. The same script
drives both: ok answers, a 400, a 429 under ``TenantQuotas``, replica 1
failed until it is ejected, replica 0's batcher killed (``/healthz`` 503),
the probe that revives it and re-admits replica 1 (``/healthz`` 200), a
last ok answer, and ``close()``. After each step the script waits until the
step's spans are on both streams, so the non-span events sit at the same
places. The two streams must then have the same sequence of event types;
between two non-span events the same spans (name, path, parent and tags,
the durations and span ids aside, ``phases`` by its keys); the same
``mitigation`` events in order and the same ``fault`` events, field for
field; and the same request counters in the final ``metrics`` event. Both
write with ``DIB_TELEMETRY_STRICT=1``, and every event of the port's
stream passes ``validate_event`` under the JAX package's ``EVENT_SCHEMA``.
The JAX engine is built without ``telemetry``: it would write ``compile``
events, which the port has no counterpart of. Every test has a deadline of
DEADLINE_S seconds.
"""

import json
import os
import signal
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.faults.serve import FlakyEngine as JaxFlakyEngine
from dib_tpu.faults.serve import kill_batcher_worker as jax_kill_batcher_worker
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.serve import DIBServer as JaxServer
from dib_tpu.serve import InferenceEngine as JaxEngine
from dib_tpu.serve import MicroBatcher as JaxBatcher
from dib_tpu.serve import ReplicaEntry as JaxEntry
from dib_tpu.serve import ReplicaRouter as JaxRouter
from dib_tpu.serve import TenantQuotas as JaxQuotas
from dib_tpu.telemetry import EventWriter as JaxWriter
from dib_tpu.telemetry import MetricsRegistry as JaxRegistry
from dib_tpu.telemetry.events import EVENT_SCHEMA as JAX_SCHEMA
from dib_tpu.telemetry.trace import Tracer as JaxTracer
from dib_tpu_torch import cli, interop
from dib_tpu_torch.faults import FlakyEngine, kill_batcher_worker
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.serve import (
    DIBServer,
    InferenceEngine,
    MicroBatcher,
    ReplicaEntry,
    ReplicaRouter,
    TenantQuotas,
)
from dib_tpu_torch.telemetry import EventWriter, MetricsRegistry, read_events, validate_event
from dib_tpu_torch.telemetry.trace import Tracer

torch.set_num_threads(1)

DEADLINE_S = 60
BUCKETS = (1, 8)
CONFIG = dict(encoder_hidden=(8,), integration_hidden=(16,), output_dim=1, embedding_dim=2)
GREEDY = {"greedy": (1e-3, 1.0)}     # one request of burst, then 429
# the envelope, the span ids and the clock readings: the fields that differ
# between two runs of one script
UNSTABLE = {"v", "run", "proc", "seq", "t", "mono", "ctx", "tags", "span", "seconds"}


@pytest.fixture(autouse=True)
def deadline():
    """Fail a test that runs past DEADLINE_S (it waits on sockets)."""
    def expire(*_):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("DIB_TELEMETRY_STRICT", "1")


def _post(url: str, body, headers: dict | None = None) -> int:
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as exc:
        exc.read()
        return exc.code


def _get(url: str) -> int:
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as exc:
        exc.read()
        return exc.code


@pytest.fixture(scope="module")
def bundle():
    return jax_get_dataset("boolean_circuit")


@pytest.fixture(scope="module")
def flax_params(bundle):
    """Seeded parameters in the Flax layout (cheaper than a Flax init)."""
    source = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    return interop.params_to_flax(source)


def _jax_stack(bundle, params, directory):
    writer = JaxWriter(str(directory))
    registry, tracer = JaxRegistry(), JaxTracer(writer)
    engine = JaxEngine(JaxDIB(feature_dimensionalities=tuple(bundle.feature_dimensionalities),
                              **CONFIG), params, batch_buckets=BUCKETS,
                       device=jax.local_devices()[0])
    flaky = JaxFlakyEngine(engine, telemetry=writer, replica=1)
    entries = [JaxEntry(eng, JaxBatcher(eng, max_batch=8, max_wait_ms=1.0, tracer=tracer,
                                        registry=registry), i)
               for i, eng in enumerate((engine, flaky))]
    router = JaxRouter(entries, eject_after=1, probe_after_s=0.0, telemetry=writer,
                       registry=registry)
    server = JaxServer(router, telemetry=writer, registry=registry, tracer=tracer,
                       quotas=JaxQuotas(0.0, overrides=GREEDY))
    return writer, router, flaky, server, jax_kill_batcher_worker


def _port_stack(bundle, params, directory):
    writer = EventWriter(str(directory))
    registry, tracer = MetricsRegistry(), Tracer(writer)
    model = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in interop.params_from_flax(params).items()})
    engine = InferenceEngine(model, batch_buckets=BUCKETS, device="cpu")
    flaky = FlakyEngine(engine, telemetry=writer, replica=1)
    entries = [ReplicaEntry(eng, MicroBatcher(eng, max_batch=8, max_wait_ms=1.0, tracer=tracer,
                                              registry=registry), i)
               for i, eng in enumerate((engine, flaky))]
    router = ReplicaRouter(entries, eject_after=1, probe_after_s=0.0, telemetry=writer,
                           registry=registry)
    server = DIBServer(router, telemetry=writer, registry=registry, tracer=tracer,
                       quotas=TenantQuotas(0.0, overrides=GREEDY))
    return writer, router, flaky, server, kill_batcher_worker


def _spans(path: str) -> tuple[int, int]:
    events = list(read_events(path))
    names = [e.get("name") for e in events if e.get("type") == "span"]
    return names.count("request"), names.count("batch")


def _settle(path: str, requests: int, batches: int) -> None:
    """Wait until the stream holds this many request and batch spans (a
    request span is written after the socket write, so after the client
    already has its answer)."""
    end = time.monotonic() + 20
    while _spans(path) != (requests, batches):
        assert time.monotonic() < end, (path, _spans(path), requests, batches)
        time.sleep(0.01)


def _drive(stack, rows, directory) -> dict:
    """The script; returns the HTTP statuses it saw."""
    writer, router, flaky, server, kill = stack
    path = str(directory)
    writer.run_start({"mode": "serve"})
    server.start()
    url = server.url
    statuses = []
    try:
        spans = [0, 0]

        def post(body, headers=None, request=1, batch=1):
            statuses.append(_post(url + body.pop("route", "/v1/predict"), body, headers))
            spans[0] += request
            spans[1] += batch
            _settle(path, *spans)

        post({"x": rows[0].tolist()})                                    # ok, replica 0
        post({"x": rows[:3].tolist()})                                   # ok, replica 1
        post({"x": rows[:2].tolist(), "route": "/v1/encode"})            # ok, encode
        post({"x": [[1.0, 2.0, 3.0]]}, request=0, batch=0)               # 400: no span
        post({"x": rows[:2].tolist()}, {"X-DIB-Tenant": "greedy"})       # ok
        post({"x": rows[:2].tolist()}, {"X-DIB-Tenant": "greedy"}, batch=0)   # 429
        flaky.fail_next = 2          # the batch and its per-request retry both fail
        post({"x": rows[:1].tolist()})                                   # ejects replica 1
        post({"x": rows[:1].tolist(), "tenant": "polite"})
        assert router.entries[1].ejected
        assert kill(router.entries[0].batcher, telemetry=writer)
        statuses.append(_get(url + "/healthz"))                          # 503: unhealthy
        assert router.probe_ejected(force=True) == 1                     # revive + readmit
        statuses.append(_get(url + "/healthz"))                          # 200: recovered
        post({"x": rows[:4].tolist()})
    finally:
        server.close()
    return statuses


def _without(event: dict, drop=UNSTABLE) -> dict:
    out = {k: v for k, v in event.items() if k not in drop}
    if "phases" in out:
        out["phases"] = sorted(out["phases"])
    return out


def _segments(events):
    """The spans between consecutive non-span events, each sorted."""
    segments, current = [], []
    for e in events:
        if e["type"] == "span":
            current.append(json.dumps(_without(e), sort_keys=True))
        else:
            segments.append(sorted(current))
            current = []
    return segments + [sorted(current)]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_the_serve_stream_matches_the_jax_server(bundle, flax_params, tmp_path):
    rows = np.asarray(bundle.x_valid[:8], np.float32)
    want_statuses = _drive(_jax_stack(bundle, flax_params, tmp_path / "jax"), rows,
                           tmp_path / "jax")
    got_statuses = _drive(_port_stack(bundle, flax_params, tmp_path / "port"), rows,
                          tmp_path / "port")
    assert got_statuses == want_statuses == [200, 200, 200, 400, 200, 429, 200, 200, 503, 200,
                                             200]
    want = list(read_events(str(tmp_path / "jax")))
    got = list(read_events(str(tmp_path / "port")))
    for event in got:
        assert validate_event(event, JAX_SCHEMA) == [], event
    assert [e["type"] for e in got] == [e["type"] for e in want]
    assert got[0]["type"] == "run_start" and [e["type"] for e in got[-2:]] == ["metrics",
                                                                              "run_end"]
    assert _segments(got) == _segments(want)

    def of(kind, events):
        return [_without(e) for e in events if e["type"] == kind]

    assert of("mitigation", got) == of("mitigation", want)
    assert [m["mtype"] for m in of("mitigation", got)] == [
        "replica_ejected", "serving_unhealthy", "batcher_restarted", "replica_readmitted",
        "serving_recovered"]
    assert of("fault", got) == of("fault", want)
    assert [f["kind"] for f in of("fault", got)] == ["replica_error", "replica_error",
                                                    "batcher_crash"]
    assert all(f["replica"] == 1 for f in of("fault", got)[:2])
    requests = [e for e in got if e["type"] == "span" and e["name"] == "request"]
    assert sorted(e["status"] for e in requests) == ["ok"] * 7 + ["quota"]
    assert all(abs(sum(e["phases"].values()) - e["seconds"]) < 1e-5 for e in requests)
    batches = [e for e in got if e["type"] == "span" and e["name"] == "batch"]
    assert sum(e["rows"] for e in batches) == 1 + 3 + 2 + 2 + 1 + 1 + 4

    def counters(events):
        snapshot = [e for e in events if e["type"] == "metrics"][-1]["snapshots"][0]
        return {k: v for k, v in snapshot.items() if k.startswith("counters.serve.")}

    assert counters(got) == counters(want)


# the serve manifest's keys in the JAX package's ``serve`` (dib_tpu/cli.py)
JAX_SERVE_MANIFEST = {"mode", "dataset", "checkpoint_dir", "buckets", "max_batch", "max_wait_ms",
                      "sweep", "workers", "quota_rps", "admission_limit", "response_cache",
                      "exec_cache"}
MODEL_FLAGS = ["--feature_encoder_architecture", "8", "--integration_network_architecture",
               "16", "--feature_embedding_dimension", "2"]


def test_serve_writes_its_stream_into_outdir_by_default(tmp_path, capsys):
    """``serve`` with no ``--telemetry-dir`` writes ``<outdir>/events.jsonl``:
    the JAX manifest's keys with ``mode: "serve"``, then the metrics rollup
    and ``run_end`` at shutdown; ``--telemetry-dir ''`` writes none."""
    ckpt = str(tmp_path / "ckpt")
    cli.run(cli.build_parser().parse_args(
        ["train", "--artifact_outdir", str(tmp_path / "run"), *MODEL_FLAGS,
         "--number_pretraining_epochs", "1", "--number_annealing_epochs", "1",
         "--batch_size", "64", "--steps_per_epoch", "1", "--max_val_points", "64",
         "--checkpoint_dir", ckpt, "--checkpoint_frequency", "1"]), device="cpu")
    for outdir, extra in (("serve", []), ("quiet", ["--telemetry-dir", ""])):
        assert cli.main(["serve", "--checkpoint_dir", ckpt, *MODEL_FLAGS, "--port", "0",
                         "--outdir", str(tmp_path / outdir), "--serve_seconds", "0.1",
                         *extra], device="cpu") == 0
    hello = json.loads(capsys.readouterr().out.splitlines()[-4])
    assert hello["run_dir"] == str(tmp_path / "serve")
    events = list(read_events(str(tmp_path / "serve")))
    assert [e["type"] for e in events] == ["run_start", "metrics", "run_end"]
    assert all(validate_event(e, JAX_SCHEMA) == [] for e in events)
    manifest = events[0]["manifest"]
    assert JAX_SERVE_MANIFEST <= set(manifest) and manifest["mode"] == "serve"
    assert manifest["exec_cache"] == 0 and manifest["sweep"] is False
    assert not os.path.exists(tmp_path / "quiet" / "events.jsonl")


# a stand-in serve worker: writes one event with the port's writer into its
# --outdir, prints a hello line, and exits 0 after its --serve_seconds
FAKE_WORKER = r"""
import json, sys, time
from dib_tpu_torch.telemetry.events import EventWriter
port = int(sys.argv[sys.argv.index("--port") + 1])
outdir = sys.argv[sys.argv.index("--outdir") + 1]
EventWriter(outdir).run_start({"mode": "serve"})
print(json.dumps({"serving": f"http://127.0.0.1:{port}", "port": port, "replicas": 1,
                  "models": ["default"]}), flush=True)
time.sleep(float(sys.argv[sys.argv.index("--serve_seconds") + 1]))
"""


def test_prefork_workers_write_their_own_streams_under_one_trace(tmp_path, monkeypatch):
    """``serve --prefork 2`` pins the fleet's trace context before it spawns
    its workers: each worker writes ``<outdir>/worker<K>/events.jsonl``, and
    every stream carries the one ``trace_id`` (stand-in workers)."""
    from dib_tpu_torch.telemetry import context

    for name in (context.TRACE_ENV, context.TRACE_PARENT_ENV, context.TRACE_ORIGIN_ENV):
        monkeypatch.setenv(name, "x")            # restored (to unset) after the test
        monkeypatch.delenv(name)
    monkeypatch.setattr(cli, "_entry_command",
                        lambda device: [sys.executable, "-c", FAKE_WORKER])
    code = cli.main(["serve", "--checkpoint_dir", "ckpt", "--prefork", "2", "--port", "0",
                     "--outdir", str(tmp_path), "--serve_seconds", "0.5"], device="cpu")
    assert code == 0
    trace_ids = set()
    for k in range(2):
        [event] = read_events(str(tmp_path / f"worker{k}"))
        trace_ids.add(event["ctx"]["trace_id"])
        assert event["ctx"]["origin"] == ["serve"]
    assert len(trace_ids) == 1 and trace_ids == {os.environ[context.TRACE_ENV]}
