"""The port's HTTP serve stack against the JAX package's, side by side.

Both servers run in this process on ephemeral ports over the same
parameters (a tiny boolean-circuit model: encoders (8,), integration (16,),
embedding 2, buckets (1, 8)), carried into the port with
``interop.params_from_flax``. The same request bodies, in the same order,
must give equal status codes, equal payload keys, equal strings and numbers
within TOL; ``/healthz`` and ``/v1/models`` must have the same structure,
and ``/metrics`` the same counter and histogram names after the same
traffic. A β-sweep of three members must route each β to the same member
and answer with the same numbers: the JAX sweep's stacked state is built
around the three members' weights carried from a port model with
replicas=3 (``interop.params_to_flax``), with the JAX optimizer's own init;
a Flax ``init`` would compile for ~9 s on one core.
The port's ``serve`` parser must hold every flag of the JAX one with its
default, or refuse it naming its ROADMAP item.

Tolerance: TOL = 1e-5 absolute and relative (float32 matmuls accumulated
in different orders). Every test has a deadline of DEADLINE_S seconds.
"""

import json
import math
import signal
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dib_tpu.cli as jax_cli
from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.parallel import BetaSweepTrainer as JaxSweep
from dib_tpu.serve import DIBServer as JaxServer
from dib_tpu.serve import ExecutableLRU as JaxExecutableLRU
from dib_tpu.serve import ReplicaRouter as JaxRouter
from dib_tpu.serve import TenantQuotas as JaxQuotas
from dib_tpu.telemetry import MetricsRegistry as JaxRegistry
from dib_tpu.telemetry import metrics as jax_metrics
from dib_tpu.train import TrainConfig as JaxConfig
from dib_tpu.train.loop import TrainState as JaxTrainState
from dib_tpu_torch import cli, interop
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.parallel import BetaSweepTrainer
from dib_tpu_torch.serve import DIBServer, ModelZoo, ReplicaRouter, TenantQuotas
from dib_tpu_torch.telemetry import MetricsRegistry
from dib_tpu_torch.telemetry import metrics
from dib_tpu_torch.train import TrainConfig

torch.set_num_threads(1)

TOL = 1e-5
DEADLINE_S = 60
BUCKETS = (1, 8)
CONFIG = dict(encoder_hidden=(8,), integration_hidden=(16,), output_dim=1, embedding_dim=2)
SWEEP_ENDS = (0.01, 0.1, 1.0)
# β values routed over the sweep: between, beyond and on the endpoints, and
# 0 and a negative value (the linear-distance fallback)
BETAS = (0.001, 0.02, 0.05, 0.2, 0.5, 3.0, 0.1, 0.0, -1.0)
ROADMAP = "ROADMAP.md"
# the tenant with a quota: one request of burst, then 429
GREEDY = {"greedy": (1e-3, 1.0)}


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


def _post(url: str, body, headers: dict | None = None) -> tuple[int, dict]:
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
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


def assert_same(got, want, where: str = "payload"):
    """Equal structure: dict keys, list lengths, strings; numbers within TOL.
    A replica's ``device`` names the framework's device and is skipped."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (where, got, want)
        for key in want:
            if key != "device":
                assert_same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, (where, got, want)
    else:
        assert isinstance(got, (int, float)) and not isinstance(got, bool), (where, got)
        assert math.isclose(got, want, rel_tol=TOL, abs_tol=TOL), (where, got, want)


@pytest.fixture(scope="module")
def bundle():
    return jax_get_dataset("boolean_circuit")


@pytest.fixture(scope="module")
def jax_model(bundle):
    return JaxDIB(feature_dimensionalities=tuple(bundle.feature_dimensionalities), **CONFIG)


@pytest.fixture(scope="module")
def flax_params(bundle):
    """Seeded parameters in the Flax layout (cheaper than a Flax init)."""
    source = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    return interop.params_to_flax(source)


@pytest.fixture(scope="module")
def servers(bundle, jax_model, flax_params):
    """(JAX server, port server) over the same weights, quotas on for the
    greedy tenant only, registries on."""
    jax_registry = JaxRegistry()
    jax_router = JaxRouter.from_params(jax_model, flax_params, devices=jax.local_devices()[:1],
                                       batch_buckets=BUCKETS, registry=jax_registry,
                                       max_batch=8, max_wait_ms=1.0)
    jax_server = JaxServer(jax_router, registry=jax_registry,
                           quotas=JaxQuotas(0.0, overrides=GREEDY)).start()
    registry = MetricsRegistry()
    zoo = ModelZoo(registry=registry)
    model = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu")
    zoo.add_params("default", model, interop.params_from_flax(flax_params), devices=["cpu"],
                   batch_buckets=BUCKETS, registry=registry, max_batch=8, max_wait_ms=1.0)
    server = DIBServer(zoo, registry=registry, quotas=TenantQuotas(0.0, overrides=GREEDY)).start()
    yield jax_server, server
    server.close()
    jax_server.close()


def _bodies(bundle):
    x = np.asarray(bundle.x_valid[:20], np.float32)
    return [
        ("/v1/predict", {"x": x[0].tolist()}, None),                      # 1 row
        ("/v1/predict", {"x": x[:3].tolist()}, None),                     # 3 rows
        ("/v1/predict", {"x": x.tolist()}, None),                         # 20 rows: 8 + 8 + 4
        ("/v1/encode", {"x": x[:2].tolist()}, None),
        ("/v1/predict", {"x": [[1.0, 2.0, 3.0]]}, None),                  # wrong width
        ("/v1/predict", {"x": [[float("nan")] * x.shape[1]]}, None),      # non-finite
        ("/v1/predict", {"x": x[:1].tolist(), "model": "nope"}, None),    # unknown model
        ("/v1/nope", {"x": x[:1].tolist()}, None),                        # unknown route
        ("/v1/predict", {"x": x[:1].tolist(), "beta": 0.1}, None),        # beta, no sweep
        ("/v1/predict", {"x": x[:2].tolist()}, {"X-DIB-Tenant": "greedy"}),
        ("/v1/predict", {"x": x[:2].tolist()}, {"X-DIB-Tenant": "greedy"}),   # over quota
        ("/v1/predict", {"x": x[:2].tolist(), "tenant": "polite"}, None),
    ]


def test_requests_match_the_jax_server(servers, bundle):
    jax_server, server = servers
    statuses = []
    for path, body, headers in _bodies(bundle):
        want = _post(jax_server.url + path, body, headers)
        got = _post(server.url + path, body, headers)
        assert got[0] == want[0], (path, body, got, want)
        if path == "/v1/predict" and want[0] == 429:
            # the refill horizon is a clock reading: equal keys, both positive
            assert sorted(got[1]) == sorted(want[1]) and got[1]["retry_after_s"] > 0
            assert got[1]["error"] == want[1]["error"]
        else:
            assert_same(got[1], want[1], path)
        statuses.append(got[0])
    assert statuses == [200, 200, 200, 200, 400, 400, 404, 404, 400, 200, 429, 200]


def test_get_routes_match_the_jax_server(servers, bundle):
    jax_server, server = servers
    for path, body, headers in _bodies(bundle)[:4]:        # the same traffic on both
        assert _post(jax_server.url + path, body, headers)[0] == 200
        assert _post(server.url + path, body, headers)[0] == 200
    for path in ("/healthz", "/v1/models"):
        want, got = _get(jax_server.url + path), _get(server.url + path)
        assert got[0] == want[0] == 200
        assert_same(got[1], want[1], path)
    want, got = _get(jax_server.url + "/metrics"), _get(server.url + "/metrics")
    for family in ("counters", "histograms"):
        assert sorted(got[1][family]) == sorted(want[1][family]), family
    # the port's /metrics adds this process's kernel launches: none on the CPU
    assert got[1]["kernel_launches"] == dict.fromkeys(
        ("mi_row_stats", "log_density_mat", "flash_attention", "flash_attention_bf16"), 0)
    assert {"serve.requests.ok", "serve.batches", "serve.dispatches.predict",
            "serve.dispatches.encode"} <= set(got[1]["counters"])
    assert {f"serve.phase.{p}" for p in ("read", "parse", "admission", "queue", "batch",
                                        "dispatch", "serialize", "write")} \
        <= set(got[1]["histograms"])
    with urllib.request.urlopen(server.url + "/metrics?format=prometheus", timeout=30) as resp:
        text = resp.read().decode()
        assert resp.headers["Content-Type"].startswith("text/plain")
    assert "# TYPE dib_serve_requests_ok counter" in text
    assert 'dib_serve_request_latency_s_hist_bucket{le="+Inf"}' in text


def _feed_metrics(module, seed=0):
    """One seeded stream of counter increments, gauge sets and histogram
    observations into a fresh registry of ``module``. Observations span
    the buckets' whole range and past both ends, and include the bounds
    themselves; one histogram has a window of 16 and one stays empty."""
    rng = np.random.default_rng(seed)
    registry = module.MetricsRegistry()
    counters = ("serve.requests.ok", "serve.dispatches.predict", "odd-name/x")
    gauges = ("serve.queue_depth", "neg", "nan")
    registry.histogram("serve.phase.empty")
    for _ in range(400):
        kind = rng.integers(3)
        if kind == 0:
            registry.counter(counters[rng.integers(3)]).inc(float(rng.integers(0, 5)))
        elif kind == 1:
            name = gauges[rng.integers(3)]
            value = float("nan") if name == "nan" else float(rng.normal() * 1e3)
            registry.gauge(name).set(value)
        elif rng.random() < 0.2:
            registry.histogram("serve.windowed", window=16).record(
                module.BUCKET_BOUNDS[rng.integers(len(module.BUCKET_BOUNDS))])
        else:
            registry.histogram("serve.request_latency_s").record(10.0 ** rng.uniform(-7.5, 2.5))
    return registry


def test_metrics_registry_matches_the_jax_registry():
    """The port's copy of the metrics module against the JAX one on the same
    seeded stream: bucket bounds, snapshots, dense bucket counts (also after
    a JSON round trip and a two-worker merge), quantiles, the Prometheus
    text and the gathered snapshots. Tolerance: none, equal values (both
    are the same pure-Python arithmetic)."""
    assert metrics.BUCKET_BOUNDS == jax_metrics.BUCKET_BOUNDS
    probes = [0.0, -1.0, 1e-9, 1e3, *metrics.BUCKET_BOUNDS[::7],
              *(np.nextafter(b, 1.0) for b in metrics.BUCKET_BOUNDS[::9])]
    assert [metrics.bucket_index(v) for v in probes] == \
        [jax_metrics.bucket_index(v) for v in probes]
    registry, jax_registry = _feed_metrics(metrics), _feed_metrics(jax_metrics)
    snap, jax_snap = registry.snapshot(), jax_registry.snapshot()
    assert json.dumps(snap, sort_keys=True) == json.dumps(jax_snap, sort_keys=True)
    quantiles = (0.0, 0.01, 0.5, 0.9, 0.99, 1.0)
    for name, hist in snap["histograms"].items():
        counts = metrics.bucket_counts(hist)
        assert counts == jax_metrics.bucket_counts(jax_snap["histograms"][name]), name
        floated = json.loads(json.dumps({k: float(v) for k, v in hist.items()}))
        assert metrics.bucket_counts(floated) == jax_metrics.bucket_counts(floated), name
        merged = [a + b for a, b in zip(counts, metrics.bucket_counts(floated))]
        for counts_of in (counts, merged):
            assert [metrics.bucket_quantile(counts_of, q) for q in quantiles] == \
                [jax_metrics.bucket_quantile(counts_of, q) for q in quantiles], name
    for prefix in ("dib", "fleet"):
        assert metrics.prometheus_text(snap, prefix) == \
            jax_metrics.prometheus_text(jax_snap, prefix)
    # through JSON: the NaN gauge is equal to itself only as text
    assert json.dumps(metrics.gather_snapshots(registry)) == \
        json.dumps(jax_metrics.gather_snapshots(jax_registry))


@pytest.fixture(scope="module")
def sweep_servers(bundle, jax_model):
    """(JAX server, port server) over the three members of a sweep: a port
    model with replicas=3 from three seeds, its stacked tree carried into a
    JAX sweep state (the optimizer state from the JAX sweep's optimizer)."""
    config = JaxConfig(batch_size=32, num_pretraining_epochs=1, num_annealing_epochs=1,
                       steps_per_epoch=1, max_val_points=64)
    jax_sweep = JaxSweep(jax_model, bundle, config, 1e-4, list(SWEEP_ENDS))
    model = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu",
                               replicas=len(SWEEP_ENDS),
                               generator=[torch.Generator().manual_seed(s) for s in (1, 2, 3)])
    params = {"model": jax.tree.map(jnp.asarray, interop.params_to_flax(model))}
    states = JaxTrainState(params, jax.vmap(jax_sweep.base.optimizer.init)(params),
                           jnp.zeros((len(SWEEP_ENDS),), jnp.int32))
    # lazily compiled executables: only the (op, bucket) pairs the test uses
    jax_router = JaxRouter.from_sweep(jax_sweep, states, batch_buckets=BUCKETS, max_wait_ms=0.0,
                                      exec_cache=JaxExecutableLRU(16), cache_key="sweep")
    jax_server = JaxServer(jax_router).start()
    sweep = BetaSweepTrainer(model, get_dataset("boolean_circuit"),
                             TrainConfig(batch_size=32, num_pretraining_epochs=1,
                                         num_annealing_epochs=1, steps_per_epoch=1,
                                         max_val_points=64),
                             1e-4, SWEEP_ENDS, device="cpu")
    port_states, _ = sweep.init()
    router = ReplicaRouter.from_sweep(sweep, port_states, batch_buckets=BUCKETS, max_wait_ms=0.0)
    server = DIBServer(router).start()
    yield jax_server, server
    server.close()
    jax_server.close()


def test_beta_sweep_routes_like_the_jax_server(sweep_servers, bundle):
    jax_server, server = sweep_servers
    x = np.asarray(bundle.x_valid[:3], np.float32).tolist()
    chosen = set()
    for beta in BETAS:
        for op in ("predict", "encode"):
            want = _post(f"{jax_server.url}/v1/{op}", {"x": x, "beta": beta})
            got = _post(f"{server.url}/v1/{op}", {"x": x, "beta": beta})
            assert got[0] == want[0] == 200, (beta, got, want)
            assert got[1]["replica"]["replica"] == want[1]["replica"]["replica"], beta
            assert_same(got[1], want[1], f"beta={beta} {op}")
        chosen.add(got[1]["replica"]["replica"])
    assert chosen == {0, 1, 2}
    assert got[1]["replica"]["replica"] == 0        # beta -1: nearest endpoint, linearly
    for path in ("/healthz", "/v1/models"):
        assert_same(_get(server.url + path)[1], _get(jax_server.url + path)[1], path)


def test_serve_parser_keeps_every_jax_flag_or_refuses_it(capsys):
    port = {a.dest: a for a in cli.serve_parser()._actions}
    jax_actions = [a for a in jax_cli.serve_parser()._actions if a.dest != "help"]
    for action in jax_actions:
        assert action.dest in port, action.dest
        assert port[action.dest].default == action.default, action.dest
        assert port[action.dest].option_strings == action.option_strings, action.dest
    argv = ["--checkpoint_dir", "ckpt"]
    assert vars(cli.serve_parser().parse_args(argv)) == vars(jax_cli.serve_parser().parse_args(argv))
    for refused in (["--exec_cache", "8"], ["--infonce_loss", "--sweep_beta_ends", "0.1"]):
        with pytest.raises(SystemExit) as excinfo:
            cli.serve_parser().parse_args([*argv, *refused])
        assert excinfo.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()[-1]
        assert "not ported" in err and ROADMAP in err, err
    accepted = cli.serve_parser().parse_args([*argv, "--telemetry-dir", "", "--exec_cache", "0"])
    assert accepted.telemetry_dir == "" and accepted.exec_cache == 0
    # every dataset of the JAX registry is ported
    assert cli.serve_refusal(cli.serve_parser().parse_args([*argv, "--dataset", "diabetes"])) is None
    # the event stream and the run registry are ported: the flags are taken
    accepted = cli.serve_parser().parse_args([*argv, "--telemetry-dir", "events",
                                              "--runs-root", "runs"])
    assert accepted.telemetry_dir == "events" and accepted.runs_root == "runs"
    assert cli.serve_refusal(accepted) is None
