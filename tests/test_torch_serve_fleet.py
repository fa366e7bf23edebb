"""The port's serve stack on its own: health, the zoo's cache, the phase
clock, the engine-subprocess pool, the prefork helpers, ``serve top`` and
``python -m dib_tpu_torch serve`` over a checkpoint of the port's ``train``.

Mirrors ``tests/test_serve_health.py``, ``test_serve_zoo.py``,
``test_serve_phases.py``, ``test_serve_pool.py`` and
``test_serve_prefork.py`` on the tiny boolean-circuit model of
``tests/test_torch_serve.py`` (encoders (8,), integration (16,), embedding
2, buckets (1, 8)) on the CPU. Served numbers are held to the direct engine
at SERVE_TOL = 1e-6 (the same code on the same device; the batcher only
pads and splits rows). Every test has a deadline of DEADLINE_S seconds:
they wait on sockets, threads and worker processes.
"""

import json
import os
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dib_tpu_torch import cli
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.faults import FlakyEngine, InjectedReplicaFault, kill_batcher_worker
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.serve import (
    DIBServer,
    InferenceEngine,
    MicroBatcher,
    ModelZoo,
    ReplicaEntry,
    ReplicaRouter,
    TenantQuotas,
    WorkerDiedError,
    pool_router,
)
from dib_tpu_torch.serve.prefork import reserve_port, strip_flag, supervise_prefork
from dib_tpu_torch.serve.server import _PhaseClock
from dib_tpu_torch.serve.top import serve_top_main
from dib_tpu_torch.telemetry import REQUEST_PHASES, MetricsRegistry, prometheus_text

torch.set_num_threads(1)

SERVE_TOL = 1e-6
DEADLINE_S = 60
BUCKETS = (1, 8)
CONFIG = dict(encoder_hidden=(8,), integration_hidden=(16,), output_dim=1, embedding_dim=2)
# the CLI runs whose checkpoints `serve` reads: CONFIG's model, 2 + 2 epochs
# of 2 steps; `serve` takes the model flags
MODEL_FLAGS = ["--feature_encoder_architecture", "8", "--integration_network_architecture",
               "16", "--feature_embedding_dimension", "2"]
TINY = ["--number_pretraining_epochs", "2", "--number_annealing_epochs", "2",
        "--batch_size", "64", "--steps_per_epoch", "2", "--max_val_points", "64", *MODEL_FLAGS]
SWEEP = ["--sweep_beta_ends", "0.01", "1.0"]


@pytest.fixture(autouse=True)
def deadline():
    """Fail a test that runs past DEADLINE_S."""
    def expire(*_):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _post(url: str, body) -> tuple[int, dict]:
    request = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(url: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.fixture(scope="module")
def bundle():
    return get_dataset("boolean_circuit")


@pytest.fixture(scope="module")
def model(bundle):
    return DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu",
                              generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def rows(bundle):
    return np.asarray(bundle.x_valid[:8], np.float32)


@pytest.fixture(scope="module")
def direct(model):
    return InferenceEngine(model, batch_buckets=BUCKETS, device="cpu")


def _router(model, sick=None, num=2, registry=None, **kwargs):
    """``num`` replicas over one engine; replica 0 wrapped in a FlakyEngine
    when ``sick`` gives its faults."""
    engine = InferenceEngine(model, batch_buckets=BUCKETS, device="cpu", registry=registry)
    flaky = FlakyEngine(engine, **sick) if sick is not None else None
    entries = []
    for i in range(num):
        eng = flaky if (i == 0 and flaky is not None) else engine
        entries.append(ReplicaEntry(eng, MicroBatcher(eng, max_batch=8, max_wait_ms=1.0,
                                                      registry=registry), i))
    kwargs.setdefault("probe_after_s", 0.0)      # probes are called by hand
    return ReplicaRouter(entries, registry=registry, **kwargs), flaky


def assert_served(payload, want, i):
    for key in ("prediction", "kl_per_feature"):
        np.testing.assert_allclose(payload[key][0], want[key][i], rtol=SERVE_TOL,
                                   atol=SERVE_TOL)


# ----------------------------------------------------------------- health

def test_sick_replica_is_ejected_without_failing_a_call_and_probe_readmits(
        model, rows, direct):
    router, flaky = _router(model, sick={"fail_next": 100}, eject_after=3)
    server = DIBServer(router).start()
    try:
        want = direct.predict(rows)
        for i in range(8):
            status, payload = _post(server.url + "/v1/predict", {"x": rows[i].tolist()})
            assert status == 200
            assert_served(payload, want, i)
        entry = router.entries[0]
        assert entry.ejected and entry.consecutive_failures == 3
        assert {router.route().index for _ in range(4)} == {1}
        assert router.probe_ejected(force=True) == 0 and entry.ejected   # still sick
        flaky.heal()
        assert router.probe_ejected(force=True) == 1
        assert not entry.ejected and entry.consecutive_failures == 0
        # only CONSECUTIVE failures eject: a success resets the count
        for _ in range(5):
            router.report_failure(entry, InjectedReplicaFault("blip"))
            router.report_success(entry)
        assert not entry.ejected
    finally:
        server.close()


def test_slow_probe_does_not_readmit(model):
    router, flaky = _router(model, sick={"delay_s": 0.3}, eject_after=1, probe_timeout_s=0.1)
    entry = router.entries[0]
    router.report_failure(entry, RuntimeError("timeout"))
    assert entry.ejected
    assert router.probe_ejected(force=True) == 0
    assert entry.ejected and "probe_timeout_s" in entry.last_error
    flaky.heal()
    end = time.monotonic() + 5.0
    while entry.probe_inflight and time.monotonic() < end:
        time.sleep(0.02)
    router.probe_timeout_s = DEADLINE_S / 2      # a loaded host must not fail the healed probe
    assert router.probe_ejected(force=True) == 1 and not entry.ejected
    router.close()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("fault", ["all_ejected", "batcher_dead"])
def test_healthz_503_when_no_replica_can_serve(model, rows, fault):
    router, _ = _router(model, num=2, eject_after=1)
    server = DIBServer(router).start()
    try:
        assert _get(server.url + "/healthz")[0] == 200
        for entry in router.entries:
            if fault == "all_ejected":
                router.report_failure(entry, RuntimeError("dead"))
            else:
                assert kill_batcher_worker(entry.batcher)
        status, payload = _get(server.url + "/healthz")
        assert status == 503 and payload["status"] == "unhealthy"
        assert payload["healthy_replicas"] == 0
        assert ("ejected" if fault == "all_ejected" else "batcher") in payload["detail"]
        assert payload["feature_width"] == rows.shape[1]     # the surface stays
        status, payload = _post(server.url + "/v1/predict", {"x": rows[0].tolist()})
        assert status == 503 and "health" in payload
        if fault == "batcher_dead":
            router.probe_ejected()                             # revives the workers
            assert _get(server.url + "/healthz")[0] == 200
            assert _post(server.url + "/v1/predict", {"x": rows[0].tolist()})[0] == 200
    finally:
        server.close()


def test_client_errors_never_mark_a_replica(model, rows):
    router, _ = _router(model, num=1, eject_after=1)
    server = DIBServer(router)
    try:
        for body in ({"x": [[1.0, 2.0]]}, {"x": [[float("nan")] * rows.shape[1]]},
                     {"x": rows[:1].tolist(), "beta": 0.5}, {"x": rows[:1].tolist(),
                                                              "timeout_s": "soon"},
                     {"y": 1}):
            status, _ = server.handle_post("/v1/predict", body)
            assert status == 400, body
        entry = router.entries[0]
        assert entry.consecutive_failures == 0 and not entry.ejected
    finally:
        server.close()


# ------------------------------------------------------- zoo and its cache

def test_response_cache_hits_and_reload_invalidates(model, bundle, rows, direct):
    registry = MetricsRegistry()
    zoo = ModelZoo(response_capacity=8, registry=registry)
    zoo.add_params("default", model, devices=["cpu"], batch_buckets=BUCKETS,
                   registry=registry, max_wait_ms=0.0)
    other = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    zoo.add_params("other", other, devices=["cpu"], batch_buckets=BUCKETS, max_wait_ms=0.0)
    server = DIBServer(zoo, registry=registry).start()
    try:
        body = {"x": rows[:3].tolist()}
        first = _post(server.url + "/v1/predict", body)[1]
        hit = _post(server.url + "/v1/predict", body)[1]
        assert "cached" not in first and hit["cached"] is True
        np.testing.assert_array_equal(hit["prediction"], first["prediction"])
        np.testing.assert_allclose(first["prediction"], direct.predict(rows[:3])["prediction"],
                                   rtol=SERVE_TOL, atol=SERVE_TOL)
        named = _post(server.url + "/v1/predict", {**body, "model": "other"})[1]
        assert named["model"] == "other" and "cached" not in named
        # reload "default" with other's weights: its cached answers go
        zoo.reload("default", ReplicaRouter.from_params(other, devices=["cpu"],
                                                        batch_buckets=BUCKETS, max_wait_ms=0.0))
        after = _post(server.url + "/v1/predict", body)[1]
        assert "cached" not in after
        np.testing.assert_array_equal(after["prediction"], named["prediction"])
        counters = registry.snapshot()["counters"]
        assert counters["serve.cache.response.hits"] == 1
        assert counters["serve.cache.response.invalidations"] == 1
        assert counters["serve.zoo.reloads"] == 1
        models = _get(server.url + "/v1/models")[1]["models"]
        assert [(m["model"], m["reloads"]) for m in models] == [("default", 1), ("other", 0)]
        with pytest.raises(KeyError):
            zoo.reload("nope", zoo.resolve("other")[1])
    finally:
        server.close()


# -------------------------------------------------------------- phase clock

def test_metrics_buckets_merge_and_render():
    """Two registries' bucket counts summed give the quantiles of the
    combined stream; the snapshot renders as Prometheus text and gathers as
    one flat snapshot per process."""
    from dib_tpu_torch.telemetry import bucket_counts, bucket_quantile, gather_snapshots

    a, b, both = MetricsRegistry(), MetricsRegistry(), MetricsRegistry()
    rng = np.random.default_rng(0)
    for i, value in enumerate(rng.lognormal(-6.0, 1.5, 500)):
        (a if i % 3 else b).histogram("serve.request_latency_s").record(value)
        both.histogram("serve.request_latency_s").record(value)
    merged = [x + y for x, y in zip(*(bucket_counts(r.snapshot()["histograms"][
        "serve.request_latency_s"]) for r in (a, b)))]
    want = bucket_counts(both.snapshot()["histograms"]["serve.request_latency_s"])
    assert merged == want
    assert [bucket_quantile(merged, q) for q in (0.5, 0.99)] == \
        [bucket_quantile(want, q) for q in (0.5, 0.99)]
    a.counter("serve.requests.ok").inc(1234567)
    text = prometheus_text(a.snapshot())
    assert "dib_serve_requests_ok 1234567" in text
    assert 'dib_serve_request_latency_s_hist_bucket{le="+Inf"} ' in text
    (snap,) = gather_snapshots(a)
    assert snap["proc"] == 0 and snap["counters.serve.requests.ok"] == 1234567.0


def test_phases_telescope_to_the_request_seconds(model, rows):
    clock = _PhaseClock(1.0)
    for name, t in (("read", 1.5), ("parse", 1.25), ("queue", 2.0), ("queue", 2.5),
                    ("write", 3.0)):
        clock.stamp(name, t)
    assert clock.phases() == {"read": 0.5, "parse": 0.0, "queue": 1.0, "write": 0.5}
    assert sum(clock.phases().values()) == clock.elapsed() == 2.0

    registry = MetricsRegistry()
    router, _ = _router(model, num=1, registry=registry)
    server = DIBServer(router, registry=registry).start()
    try:
        for i in range(6):
            assert _post(server.url + "/v1/predict", {"x": rows[:i + 1].tolist()})[0] == 200
        # the server records a request after its socket write: wait for the last
        end = time.monotonic() + 5.0
        while registry.histogram("serve.request_latency_s").count < 6 \
                and time.monotonic() < end:
            time.sleep(0.01)
        hists = registry.snapshot()["histograms"]
        assert hists["serve.request_latency_s"]["count"] == 6
        phases = [p for p in REQUEST_PHASES if f"serve.phase.{p}" in hists]
        assert phases == list(REQUEST_PHASES)
        total = sum(hists[f"serve.phase.{p}"]["sum"] for p in phases)
        assert abs(total - hists["serve.request_latency_s"]["sum"]) < 1e-9
    finally:
        server.close()


def test_serve_top_renders_the_server(model, rows, capsys):
    registry = MetricsRegistry()
    router, _ = _router(model, num=1, registry=registry)
    server = DIBServer(router, registry=registry, quotas=TenantQuotas(0.0)).start()
    try:
        for i in range(3):
            assert _post(server.url + "/v1/predict", {"x": rows[i].tolist()})[0] == 200
        assert serve_top_main(["--url", server.url, "--once"]) == 0
        frame = capsys.readouterr().out
        assert "1/1 worker(s) seen" in frame and f"{os.getpid()}" in frame
        for phase in REQUEST_PHASES:
            assert phase in frame
    finally:
        server.close()
    assert serve_top_main(["--url", server.url, "--once"]) == 1     # nothing answers


# --------------------------------------------------------------------- pool

def test_pool_survives_a_killed_worker_and_probe_respawns(model, rows, direct):
    router = pool_router(model, 2, batch_buckets=BUCKETS, device="cpu",
                         max_wait_ms=1.0, eject_after=1, probe_after_s=0.0,
                         probe_timeout_s=DEADLINE_S)
    server = DIBServer(router).start()
    try:
        want = direct.predict(rows)
        for i in range(4):
            status, payload = _post(server.url + "/v1/predict", {"x": rows[i].tolist()})
            assert status == 200
            assert_served(payload, want, i)
        victim = router.entries[0].engine
        assert len({e.engine.pid for e in router.entries}) == 2 and victim.device == "cpu"
        victim.kill()
        codes = []
        threads = [threading.Thread(target=lambda i=i: codes.append(
            _post(server.url + "/v1/predict", {"x": rows[i].tolist()})[0])) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert codes == [200] * 8 and router.entries[0].ejected
        assert router.probe_ejected(force=True) == 1
        assert victim.respawns == 1 and victim.alive() and not router.entries[0].ejected
        status, payload = _post(server.url + "/v1/encode", {"x": rows[:2].tolist()})
        assert status == 200
        np.testing.assert_allclose(payload["mus"], direct.encode(rows[:2])["mus"],
                                   rtol=SERVE_TOL, atol=SERVE_TOL)
    finally:
        server.close()


def test_pool_worker_that_cannot_start_raises(model):
    with pytest.raises(WorkerDiedError, match="failed to build its engine"):
        pool_router(model, 1, batch_buckets=BUCKETS, device="cuda:99")


# ------------------------------------------------------------------ prefork

def test_strip_flag_is_positional_and_takes_abbreviations():
    argv = ["--workers", "2", "--port", "8100", "--model_name", "port",
            "--prefork=3", "--prefork", "4"]
    assert strip_flag(argv, "--prefork", True) == [
        "--workers", "2", "--port", "8100", "--model_name", "port"]
    assert strip_flag(argv, "--port", True) == [
        "--workers", "2", "--model_name", "port", "--prefork=3", "--prefork", "4"]
    assert strip_flag(["--reuse_port", "--x"], "--reuse_port", False) == ["--x"]
    for spelling in ("--prefork", "--prefor", "--pref", "--prefork=3", "--prefor=3"):
        argv = ["--workers", "2", spelling] + ([] if "=" in spelling else ["3"])
        assert strip_flag(argv, "--prefork", True) == ["--workers", "2"], spelling
    with pytest.raises(ValueError, match="prefork"):
        supervise_prefork([], prefork=0, host="127.0.0.1", port=0, outdir=".")


# a stand-in serve worker: writes its argv into its --outdir, listens on its
# --port with SO_REUSEPORT, prints a hello line, and exits 0 on SIGTERM
FAKE_WORKER = r"""
import json, os, signal, socket, sys, time
port = int(sys.argv[sys.argv.index("--port") + 1])
outdir = sys.argv[sys.argv.index("--outdir") + 1]
os.makedirs(outdir)
with open(os.path.join(outdir, "argv.json"), "w") as f:
    json.dump(sys.argv[1:], f)
sock = socket.socket()
sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
sock.bind(("127.0.0.1", port))
sock.listen(8)
signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
print(json.dumps({"serving": f"http://127.0.0.1:{port}", "port": port, "replicas": 1,
                  "models": ["default"]}), flush=True)
while True:
    time.sleep(0.05)
"""


def test_supervise_prefork_forwards_sigterm_to_its_workers(tmp_path, capsys):
    """The supervisor strips --prefork, gives each worker the shared port,
    --reuse_port and its own outdir, prints one hello line for the fleet,
    and on SIGTERM stops every worker and returns 0 (stand-in workers)."""
    argv = ["--checkpoint_dir", "ckpt", "--prefor", "2", "--port", "0"]
    result = {}

    def stop_when_listening():
        end = time.monotonic() + 30
        while time.monotonic() < end and "port" not in result:
            out = capsys.readouterr().out
            if out:
                result.update(json.loads(out.splitlines()[0]))
            time.sleep(0.05)
        if callable(signal.getsignal(signal.SIGTERM)):     # the supervisor's handler
            os.kill(os.getpid(), signal.SIGTERM)

    previous = signal.getsignal(signal.SIGTERM)
    thread = threading.Thread(target=stop_when_listening)
    thread.start()
    code = supervise_prefork(argv, prefork=2, host="127.0.0.1", port=0,
                             outdir=str(tmp_path), command=(sys.executable, "-c", FAKE_WORKER))
    thread.join(timeout=30)
    assert code == 0 and signal.getsignal(signal.SIGTERM) is previous
    assert result["prefork"] == 2 and len(result["workers"]) == 2 and result["port"] > 0
    assert result["models"] == ["default"] and result["replicas_per_worker"] == 1
    for pid in result["workers"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)                      # stopped and reaped
    for k in range(2):
        with open(tmp_path / f"worker{k}" / "argv.json") as f:
            assert json.load(f) == ["--checkpoint_dir", "ckpt", "--port", str(result["port"]),
                                    "--reuse_port", "--outdir", str(tmp_path / f"worker{k}")]


def test_reserve_port_does_not_listen():
    sock, port = reserve_port("127.0.0.1")
    try:
        assert port > 0
        worker = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        worker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        worker.bind(("127.0.0.1", port))
        worker.listen(8)
        client = socket.create_connection(("127.0.0.1", port), timeout=5)
        conn, _ = worker.accept()
        conn.close()
        client.close()
        worker.close()
    finally:
        sock.close()


# --------------------------------------------------------------- the CLI

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("sweep", [False, True], ids=["serial", "sweep"])
def test_serve_main_serves_a_checkpoint_of_train(tmp_path, capsys, rows, sweep):
    """``train`` writes a checkpoint; ``serve`` in this process answers
    from it as ``InferenceEngine.from_checkpoint`` does, and SIGTERM stops
    it with exit 0 and its summary line."""
    extra = SWEEP if sweep else []
    ckpt = str(tmp_path / "ckpt")
    cli.run(cli.build_parser().parse_args(
        ["train", "--artifact_outdir", str(tmp_path / "run"), *TINY, *extra,
         "--checkpoint_dir", ckpt, "--checkpoint_frequency", "2"]), device="cpu")
    capsys.readouterr()
    args = cli.serve_parser().parse_args(["--checkpoint_dir", ckpt, *MODEL_FLAGS, *extra])
    bundle = cli._bundle_from_args(args)
    ends = [0.01, 1.0] if sweep else [None]
    from dib_tpu_torch.parallel import BetaSweepTrainer
    from dib_tpu_torch.train import DIBTrainer

    want = []
    for r in range(len(ends)):
        model, _ = cli._model_from_args(args, bundle, device="cpu",
                                        replicas=len(ends) if sweep else None)
        trainer = (BetaSweepTrainer(model, bundle, cli._serve_config(args), 1e-4, ends,
                                    device="cpu") if sweep
                   else DIBTrainer(model, bundle, cli._serve_config(args), device="cpu"))
        engine = InferenceEngine.from_checkpoint(trainer, ckpt, replica=r if sweep else None,
                                                 batch_buckets=BUCKETS)
        want.append(engine.predict(rows))
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    answers, errors = [], []

    def client():
        try:
            end = time.monotonic() + 30
            while time.monotonic() < end:
                try:
                    if _get(url + "/healthz")[0] == 200:
                        break
                except OSError:
                    time.sleep(0.05)
            for r, beta in enumerate(ends):
                body = {"x": rows.tolist(), **({"beta": beta} if sweep else {})}
                answers.append(_post(url + "/v1/predict", body))
        except Exception as exc:       # reported by the assertions below
            errors.append(exc)
        finally:
            # serve_main's handler is in place once it answered (never the
            # default action: that would end the test process)
            if answers and callable(signal.getsignal(signal.SIGTERM)):
                os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=client)
    thread.start()
    code = cli.main(["serve", "--checkpoint_dir", ckpt, *MODEL_FLAGS, *extra, "--port",
                     str(port), "--outdir", str(tmp_path / "serve"), "--buckets", "1", "8",
                     "--serve_seconds", "40"], device="cpu")
    thread.join(timeout=30)
    assert code == 0 and not errors
    hello, summary = [json.loads(line) for line in capsys.readouterr().out.splitlines()[-2:]]
    assert hello["port"] == port and hello["replicas"] == len(ends)
    assert hello["models"] == ["default"] and os.path.isdir(hello["run_dir"])
    assert summary == {"served_requests": len(ends), "batches": summary["batches"]}
    for r, (status, payload) in enumerate(answers):
        assert status == 200 and payload["replica"]["replica"] == r
        for key in ("prediction", "kl_per_feature"):
            np.testing.assert_allclose(payload[key], want[r][key], rtol=SERVE_TOL,
                                       atol=SERVE_TOL)


def test_serve_main_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve_main would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.serve_main(["--checkpoint_dir", str(tmp_path), "--port", "0"])
