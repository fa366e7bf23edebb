"""The PyTorch port's serving engine and micro-batcher vs the JAX package's
``InferenceEngine`` on the same parameters.

Tolerance 1e-5 against JAX (float32 matmuls accumulated in different
orders). Within the port, padded micro-batching must be semantically
invisible: a row's result does not depend on its batch-mates.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from dib_tpu.data import get_dataset
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.serve import InferenceEngine as JaxEngine
from dib_tpu_torch import interop
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.serve import (
    BatcherClosed,
    InferenceEngine,
    MicroBatcher,
    QueueFullError,
    RequestTimeout,
)
from dib_tpu_torch.telemetry import Tracer

torch.set_num_threads(1)

TOL = 1e-5
BUCKETS = (1, 8)
CONFIG = dict(encoder_hidden=(8,), integration_hidden=(16,), output_dim=1, embedding_dim=2)


@pytest.fixture(scope="module")
def bundle():
    return get_dataset("boolean_circuit")


@pytest.fixture(scope="module")
def flax_params(bundle):
    """Seeded parameters in the Flax layout (cheaper than a Flax init)."""
    source = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    return interop.params_to_flax(source)


@pytest.fixture(scope="module")
def jax_engine(bundle, flax_params):
    model = JaxDIB(feature_dimensionalities=tuple(bundle.feature_dimensionalities), **CONFIG)
    return JaxEngine(model, flax_params, batch_buckets=BUCKETS)


@pytest.fixture(scope="module")
def engine(bundle, flax_params):
    model = DistributedIBModel(bundle.feature_dimensionalities, **CONFIG, device="cpu")
    return InferenceEngine.from_params(model, flax_params, batch_buckets=BUCKETS, device="cpu")


@pytest.fixture(scope="module")
def rows(bundle):
    return np.asarray(bundle.x_valid[:8], np.float32)


def test_predict_and_encode_match_jax_engine(engine, jax_engine, bundle):
    big = np.asarray(bundle.x_valid[:19], np.float32)   # chunks 8 + 8 + 3 (padded to 8)
    for op in ("predict", "encode"):
        got, want = getattr(engine, op)(big), getattr(jax_engine, op)(big)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL)


def test_padded_batch_identical_to_single(engine, rows):
    batch = engine.predict(rows[:6])          # pads 6 -> bucket 8
    enc_batch = engine.encode(rows[:6])
    for i in range(6):
        single = engine.predict(rows[i])      # bucket 1, no padding
        for key in ("prediction", "kl_per_feature"):
            np.testing.assert_allclose(single[key][0], batch[key][i], rtol=1e-6, atol=1e-6)
        enc_single = engine.encode(rows[i])
        for key in ("mus", "logvars"):
            np.testing.assert_allclose(enc_single[key][0], enc_batch[key][i],
                                       rtol=1e-6, atol=1e-6)


def test_engine_shapes_buckets_and_errors(engine, rows):
    a, b = engine.predict(rows[:3]), engine.predict(rows[:3])
    np.testing.assert_array_equal(a["prediction"], b["prediction"])
    assert a["prediction"].shape == (3, 1)
    assert a["kl_per_feature"].shape == (3, engine.num_features)
    assert np.all(a["kl_per_feature"] >= 0)
    assert engine.encode(rows[:2])["mus"].shape == (2, engine.num_features, 2)
    assert [engine.bucket_for(n) for n in (1, 2, 8, 999)] == [1, 8, 8, 8]
    with pytest.raises(ValueError, match="width"):
        engine.predict(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="batch_buckets"):
        InferenceEngine(engine.model, batch_buckets=(), device="cpu")


def test_batcher_results_match_engine_under_concurrency(engine, rows):
    batcher = MicroBatcher(engine, max_batch=8, max_wait_ms=5.0)
    want = engine.predict(rows)
    results: dict[int, dict] = {}
    errors: list = []

    def client(i: int):
        try:
            results[i] = batcher(rows[i], timeout_s=30.0)
        except Exception as exc:   # fails the test below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    batcher.close()
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(8))
    for i in range(8):
        for key in ("prediction", "kl_per_feature"):
            np.testing.assert_allclose(results[i][key][0], want[key][i], rtol=1e-6, atol=1e-6)
    multi = MicroBatcher(engine, max_batch=8, max_wait_ms=1.0)
    np.testing.assert_allclose(multi(rows[:5], timeout_s=30.0)["prediction"],
                               want["prediction"][:5], rtol=1e-6, atol=1e-6)
    multi.close()


class _StubEngine:
    """Stands in for the engine: stalls on demand, fails on poisoned rows."""

    feature_width = 4
    max_bucket = 8

    def __init__(self, stall_s: float = 0.0):
        self.stall_s = stall_s

    def predict(self, x):
        time.sleep(self.stall_s)
        if np.any(np.asarray(x) > 100.0):
            raise RuntimeError("poisoned row")
        return {"prediction": np.asarray(x)[:, :1]}

    encode = predict


def test_batcher_timeouts_and_backpressure():
    slow = MicroBatcher(_StubEngine(stall_s=0.3), max_batch=1, max_wait_ms=0.0, max_queue=2)
    first = slow.submit(np.zeros(4, np.float32), timeout_s=30.0)
    second = slow.submit(np.zeros(4, np.float32), timeout_s=0.01)   # expires queued
    with pytest.raises(RequestTimeout):
        first.result(0.01)            # client-side wait shorter than the dispatch
    with pytest.raises(QueueFullError):
        for _ in range(8):            # the worker may drain one; the bound holds
            slow.submit(np.zeros(4, np.float32))
    assert first.result(10.0) is not None
    with pytest.raises(RequestTimeout, match="in queue"):
        second.result(10.0)
    slow.close()
    with pytest.raises(BatcherClosed):
        slow.submit(np.zeros(4, np.float32))


def test_batcher_error_isolation_and_validation():
    batcher = MicroBatcher(_StubEngine(), max_batch=8, max_wait_ms=50.0)
    good1 = batcher.submit(np.ones(4, np.float32), timeout_s=30.0)
    bad = batcher.submit(np.full(4, 999.0, np.float32), timeout_s=30.0)
    good2 = batcher.submit(np.full(4, 2.0, np.float32), timeout_s=30.0)
    assert good1.result(10.0)["prediction"][0][0] == 1.0
    assert good2.result(10.0)["prediction"][0][0] == 2.0
    with pytest.raises(RuntimeError, match="poisoned"):
        bad.result(10.0)
    with pytest.raises(ValueError, match="width"):
        batcher.submit(np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        batcher.submit(np.full(4, np.nan, np.float32))
    with pytest.raises(ValueError, match="op"):
        batcher.submit(np.zeros(4, np.float32), op="nope")
    assert batcher.is_alive()
    batcher.close()
    assert not batcher.is_alive()
    # a tracer receives one batch span per dispatch and one request span per
    # request the server does not span itself
    tracer = Tracer()
    stub = _StubEngine()
    stub.bucket_for = lambda n: stub.max_bucket   # the batch span names its bucket
    traced = MicroBatcher(stub, tracer=tracer, max_wait_ms=0.0)
    traced.submit(np.ones(4, np.float32), timeout_s=30.0, tenant="t").result(10.0)
    traced.submit(np.ones(4, np.float32), timeout_s=30.0, server_span=True).result(10.0)
    traced.close()
    assert tracer.timer.counts == {"batch": 2, "request": 1}
