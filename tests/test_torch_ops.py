"""PyTorch port vs the JAX package: channel math, positional encoding and the
boolean-circuit bundle, on the same numpy-seeded inputs.

Tolerance 1e-6 (relative and absolute): the same float32 formulas, summed in
possibly different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.ops import gaussian as jax_gaussian
from dib_tpu.ops import posenc as jax_posenc
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.ops import gaussian, posenc

torch.set_num_threads(1)

TOL = 1e-6


def _params(rng, *shape):
    mus = rng.normal(scale=2.0, size=shape).astype(np.float32)
    logvars = (rng.normal(scale=0.7, size=shape) - 1.0).astype(np.float32)
    return mus, logvars


def test_kl_diagonal_gaussian_matches_jax(rng):
    mus, logvars = _params(rng, 3, 5, 4)
    for axis in (-1, 0):
        want = jax_gaussian.kl_diagonal_gaussian(jnp.asarray(mus), jnp.asarray(logvars), axis=axis)
        got = gaussian.kl_diagonal_gaussian(torch.from_numpy(mus), torch.from_numpy(logvars),
                                            dim=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_reparameterize_with_injected_noise_matches_jax(rng):
    mus, logvars = _params(rng, 6, 4)
    key = jax.random.key(3)
    want = jax_gaussian.reparameterize(key, jnp.asarray(mus), jnp.asarray(logvars))
    eps = np.array(jax.random.normal(key, mus.shape, dtype=jnp.float32))
    got = gaussian.reparameterize(torch.from_numpy(mus), torch.from_numpy(logvars),
                                  eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # a generator draw is reproducible and has the channel's shape
    a = gaussian.reparameterize(torch.from_numpy(mus), torch.from_numpy(logvars),
                                torch.Generator().manual_seed(0))
    b = gaussian.reparameterize(torch.from_numpy(mus), torch.from_numpy(logvars),
                                torch.Generator().manual_seed(0))
    assert a.shape == mus.shape and torch.equal(a, b)


def test_gaussian_log_density_mat_matches_jax(rng):
    u = rng.normal(scale=2.0, size=(7, 5)).astype(np.float32)
    mus, logvars = _params(rng, 9, 5)
    want = jax_gaussian.gaussian_log_density_mat(
        jnp.asarray(u), jnp.asarray(mus), jnp.asarray(logvars))
    got = gaussian.gaussian_log_density_mat(
        torch.from_numpy(u), torch.from_numpy(mus), torch.from_numpy(logvars))
    assert got.shape == (7, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # a leading group axis is a batch of independent matrices
    grouped = gaussian.gaussian_log_density_mat(
        torch.from_numpy(np.stack([u, u])), torch.from_numpy(np.stack([mus, mus])),
        torch.from_numpy(np.stack([logvars, logvars])))
    assert torch.equal(grouped[1], got)


@pytest.mark.parametrize("num_frequencies,start_power", [(4, 1), (3, 0), (0, 1)])
def test_positional_encoding_matches_jax(rng, num_frequencies, start_power):
    """Frequency-major order [x, sin(f1 x) over dims, sin(f2 x) ...]."""
    freqs = posenc.positional_encoding_frequencies(num_frequencies, start_power)
    np.testing.assert_array_equal(
        freqs, jax_posenc.positional_encoding_frequencies(num_frequencies, start_power))
    x = rng.uniform(-1.0, 1.0, size=(2, 6, 3)).astype(np.float32)
    want = jax_posenc.positional_encoding(jnp.asarray(x), freqs)
    got = posenc.positional_encoding(torch.from_numpy(x), freqs)
    assert got.shape == (2, 6, posenc.posenc_output_dim(3, num_frequencies))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kwargs", [{}, {"boolean_random_circuit": True,
                                         "boolean_number_input_gates": 6, "seed": 3}])
def test_boolean_circuit_bundle_matches_jax(kwargs):
    want = jax_get_dataset("boolean_circuit", **kwargs)
    got = get_dataset("boolean_circuit", **kwargs)
    for field in ("x_train", "y_train", "x_valid", "y_valid"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert set(np.unique(got.x_train)) == {-1.0, 1.0}
    assert list(got.feature_dimensionalities) == list(want.feature_dimensionalities)
    assert got.extras["circuit_specification"] == want.extras["circuit_specification"]
    assert got.extras["entropy_y_bits"] == pytest.approx(want.extras["entropy_y_bits"], abs=1e-12)
    with pytest.raises(KeyError, match="Unknown dataset"):
        get_dataset("boolean_circut")


def test_as_vanilla_ib_equals_the_jax_bundle():
    got, want = get_dataset("boolean_circuit").as_vanilla_ib(), \
        jax_get_dataset("boolean_circuit").as_vanilla_ib()
    assert got.feature_dimensionalities == want.feature_dimensionalities == [10]
    assert got.feature_labels == want.feature_labels == ["All features"]
    for name in ("x_train", "y_train", "x_valid", "y_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.number_features == 1 and get_dataset("boolean_circuit").number_features == 10
