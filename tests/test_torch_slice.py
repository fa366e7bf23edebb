"""The port's first slice as a whole, and the rules it keeps.

``all_features_bounds`` (every channel's MI sandwich bounds in one kernel
launch per eval batch) is held to the JAX package's
``all_features_bounds_kernel`` by replaying the JAX key schedule's batch
indices and noise, at 1e-5 nats. The port imports nothing of JAX or of the
JAX package, and its entry points refuse to fall back to the CPU.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from dib_tpu.data import get_dataset
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.ops.gaussian import reparameterize as jax_reparameterize
from dib_tpu.train.hooks import all_features_bounds_kernel
from dib_tpu_torch import interop
from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.models import DistributedIBModel, PerParticleDIBModel
from dib_tpu_torch.parallel import BetaSweepTrainer
from dib_tpu_torch.serve import InferenceEngine
from dib_tpu_torch.train import TrainConfig
from dib_tpu_torch.train.hooks import all_features_bounds
from dib_tpu_torch.workloads import run_amorphous_sweep

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
CONFIG = dict(encoder_hidden=(8,), integration_hidden=(8,), output_dim=1, embedding_dim=4)


def _jax_draws(model, params, rows, key, batch_size, num_batches):
    """The batch indices and samples ``all_features_bounds_kernel`` draws."""
    idx, us = [], []
    for k in jax.random.split(key, num_batches):
        k_idx, k_mi = jax.random.split(k)
        batch_idx = jax.random.randint(k_idx, (batch_size,), 0, rows.shape[0])
        mus, logvars = model.encode(params, rows[batch_idx])
        keys = jax.random.split(k_mi, mus.shape[0])
        idx.append(np.asarray(batch_idx))
        us.append(np.asarray(jax.vmap(jax_reparameterize)(keys, mus, logvars)))
    return torch.from_numpy(np.stack(idx)), torch.from_numpy(np.stack(us))


def test_all_features_bounds_matches_jax():
    bundle = get_dataset("boolean_circuit")
    dims = tuple(bundle.feature_dimensionalities)
    rows = np.asarray(bundle.x_valid[:64], np.float32)
    model = DistributedIBModel(dims, **CONFIG, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    jax_model = JaxDIB(feature_dimensionalities=dims, **CONFIG)
    params = interop.params_to_flax(model)
    key, batch_size, num_batches = jax.random.key(7), 32, 2
    want_lower, want_upper = jax.jit(
        all_features_bounds_kernel(jax_model, batch_size, num_batches, None))(params, rows, key)

    idx, u = _jax_draws(jax_model, params, rows, key, batch_size, num_batches)
    lower, upper = all_features_bounds(model, rows, batch_size, num_batches, idx=idx, u=u)
    assert lower.shape == upper.shape == (len(dims),)
    np.testing.assert_allclose(lower.numpy(), np.asarray(want_lower), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(upper.numpy(), np.asarray(want_upper), rtol=TOL, atol=TOL)

    # the port's own draws: reproducible from the generator, lower <= upper
    a = all_features_bounds(model, rows, batch_size, num_batches,
                            generator=torch.Generator().manual_seed(3))
    b = all_features_bounds(model, rows, batch_size, num_batches,
                            generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool((a[0] <= a[1] + TOL).all())


def _port_sources():
    return sorted((ROOT / "dib_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    banned = ("jax", "flax", "optax", "orbax", "dib_tpu")
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
    assert len(_port_sources()) > 10
    assert not offenders, offenders


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedIBModel((1, 1), **CONFIG)
    model = DistributedIBModel((1, 1), **CONFIG, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model)
    stacked = PerParticleDIBModel(num_particles=2, encoder_hidden=(4,), embedding_dim=2,
                                  num_blocks=1, num_heads=1, key_dim=2, ff_hidden=(4,),
                                  head_hidden=(4,), device="cpu", replicas=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BetaSweepTrainer(stacked, None, TrainConfig(), 1e-3, [1e-2, 1e-1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_amorphous_sweep()


def test_chip_smoke_refuses_to_run_without_cuda(monkeypatch, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
