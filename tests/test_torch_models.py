"""The PyTorch port's models vs the JAX package's Flax models on the same
parameters (carried over through ``dib_tpu_torch.interop``) and the same
numpy-seeded inputs.

Tolerance 1e-5: float32 matmuls of a few layers, accumulated in different
orders by the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.models import MLP as JaxMLP
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.models import pad_and_stack_features as jax_pad_and_stack
from dib_tpu_torch import interop
from dib_tpu_torch.models import MLP, DistributedIBModel, pad_and_stack_features

torch.set_num_threads(1)

TOL = 1e-5
DIMS = (2, 1, 3)          # ragged features: zero-padded to width 3
CONFIG = dict(encoder_hidden=(8, 6), integration_hidden=(12,), output_dim=2,
              embedding_dim=3, num_posenc_frequencies=2, logvar_offset=-0.5)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).uniform(-1, 1, size=(5, sum(DIMS))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_pair():
    """The Flax model with the port's seeded initialisation carried over
    (cheaper than a Flax init, and the same layout)."""
    source = DistributedIBModel(DIMS, **CONFIG, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    return JaxDIB(feature_dimensionalities=DIMS, **CONFIG), interop.params_to_flax(source)


@pytest.fixture(scope="module")
def torch_model(jax_pair):
    """A differently seeded port model loaded from the Flax tree."""
    model = DistributedIBModel(DIMS, **CONFIG, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    model.load_state_dict(interop.params_from_flax(jax_pair[1]))
    return model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dims", [DIMS, (2, 2, 2), (1,) * 6])
def test_pad_and_stack_features_matches_jax(x, dims):
    got = pad_and_stack_features(torch.from_numpy(x), dims)
    assert got.shape == (len(dims), 5, max(dims))
    _close(got, jax_pad_and_stack(jnp.asarray(x), dims), 0)


@pytest.mark.parametrize("activation", ["gelu", "leaky_relu"])
def test_mlp_matches_flax(activation):
    rng = np.random.default_rng(2)
    h = rng.normal(size=(4, 6)).astype(np.float32)
    flax_mlp = JaxMLP(hidden=(5,), output_dim=3, activation=activation)
    params = jax.device_get(flax_mlp.init(jax.random.key(0), jnp.asarray(h)))["params"]
    mlp = MLP(6, (5,), 3, activation)
    mlp.load_state_dict({f"layers.{i}.{leaf}": torch.from_numpy(np.array(params[f"Dense_{i}"][leaf]))
                         for i in range(2) for leaf in ("kernel", "bias")})
    _close(mlp(torch.from_numpy(h)), flax_mlp.apply({"params": params}, jnp.asarray(h)))


def test_forward_posterior_mean_matches_jax(jax_pair, torch_model, x):
    model, params = jax_pair
    want_pred, want = model.apply(params, jnp.asarray(x), jax.random.key(2), sample=False)
    with torch.no_grad():
        got_pred, got = torch_model(torch.from_numpy(x), sample=False)
    _close(got_pred, want_pred)
    assert got["mus"].shape == (3, 5, 3)
    for key in ("kl_per_feature", "mus", "logvars", "embeddings"):
        _close(got[key], want[key])


def test_forward_sampled_with_injected_noise_matches_jax(jax_pair, torch_model, x):
    model, params = jax_pair
    key = jax.random.key(4)
    want_pred, want = model.apply(params, jnp.asarray(x), key)
    eps = np.array(jax.random.normal(key, (3, 5, 3), dtype=jnp.float32))
    with torch.no_grad():
        got_pred, got = torch_model(torch.from_numpy(x), eps=torch.from_numpy(eps))
    _close(got_pred, want_pred)
    _close(got["embeddings"], want["embeddings"])


def test_encode_and_encode_feature_match_jax(jax_pair, torch_model, x):
    model, params = jax_pair
    with torch.no_grad():
        mus, logvars = torch_model.encode(torch.from_numpy(x))
        want_mus, want_lv = model.encode(params, jnp.asarray(x))
        _close(mus, want_mus)
        _close(logvars, want_lv)
        assert mus.is_contiguous() and logvars.is_contiguous()
        start = 0
        for i, width in enumerate(DIMS):
            part = x[:, start:start + width]
            start += width
            got = torch_model.encode_feature(i, torch.from_numpy(part))
            want = model.encode_feature(params, i, jnp.asarray(part))
            for g, w in zip(got, want):
                _close(g, w)


def test_interop_round_trip(jax_pair, torch_model, x):
    """The port's tree has the Flax model's structure and shapes, and loads
    back unchanged."""
    model, params = jax_pair
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(x), jax.random.key(1))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    for s, p in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(params)):
        assert s.shape == p.shape
    tree = interop.params_to_flax(torch_model)
    flat_got = jax.tree_util.tree_leaves_with_path(tree)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="Dense_"):
        interop.params_from_flax({"params": {"encoders": {"VmapGaussianEncoder_0": {
            "MLP_0": {"Conv_0": {}}}}, "integration": {}}})


def test_fresh_init_follows_flax_at_full_width():
    """The flagship width (F=10 boolean features, CLI defaults) has the JAX
    model's parameter count; kernels are lecun-normal, biases zero, and a
    seed fixes the weights."""
    dims = (1,) * 10
    shapes = jax.eval_shape(JaxDIB(feature_dimensionalities=dims).init, jax.random.key(0),
                            jnp.zeros((2, 10)), jax.random.key(1))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    a = DistributedIBModel(dims, device="cpu", generator=torch.Generator().manual_seed(0))
    b = DistributedIBModel(dims, device="cpu", generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in a.parameters()) == want == 403585
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb)
        if name.endswith("bias"):
            assert not pa.any()
    kernel = a.encoders.mlp.layers[1].kernel          # [F, 128, 128], fan_in 128
    assert kernel.abs().max() <= 2.0 / 128 ** 0.5 / 0.87962566103423978 + 1e-6
    assert kernel.std().item() == pytest.approx(128 ** -0.5, rel=0.05)
