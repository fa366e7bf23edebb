"""The models the port's CLI flags build, against the JAX package's.

``_model_from_args`` loaded with the JAX model's initial weights through
``interop`` computes the JAX forward to 1e-5 (and the InfoNCE ``YEncoder``
its Flax counterpart's), for the default flags and for ``--ib``,
``--no-use_positional_encoding`` and ``--infonce_loss``; a ``YEncoder`` of
its own matches Flax's to 1e-6 with the same parameter tree. The JAX
reference is compiled without LLVM's optimisation passes (``_quick``),
most of its compile time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dib_tpu.cli as jax_cli
from dib_tpu.models import YEncoder as JaxYEncoder
from dib_tpu_torch import cli, interop
from dib_tpu_torch.models import YEncoder
from test_torch_cli import TINY

torch.set_num_threads(1)

TOL = 1e-5


def _quick(fn, *args):
    """``fn(*args)`` compiled without LLVM's optimisation passes (most of
    the compile time of these small programs)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@pytest.mark.parametrize("flags", [
    [],
    ["--ib", "--activation_fn", "tanh"],
    ["--no-use_positional_encoding", "--activation_fn", "leaky_relu"],
    ["--infonce_loss", "--infonce_shared_dimensionality", "8",
     "--infonce_y_encoder_architecture", "8", "--activation_fn", "gelu"],
], ids=["defaults", "ib", "no_posenc", "infonce"])
def test_model_from_args_computes_the_jax_forward(flags):
    argv = [*TINY, *flags]
    jax_args, args = jax_cli.build_parser().parse_args(argv), cli.build_parser().parse_args(argv)
    bundle = cli._bundle_from_args(args)        # numpy: the JAX package's bundle holds the same
    jax_model, jax_y = jax_cli._model_from_args(jax_args, bundle)
    model, y_encoder = cli._model_from_args(args, bundle, device="cpu")
    x = np.random.default_rng(40).choice([-1.0, 1.0], size=(16, 10)).astype(np.float32)
    params = _quick(jax_model.init, jax.random.key(3), jnp.asarray(x), jax.random.key(4))
    model.load_state_dict(interop.params_from_flax(params))
    want, want_aux = _quick(functools.partial(jax_model.apply, sample=False), params,
                            jnp.asarray(x), jax.random.key(4))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x), sample=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux["kl_per_feature"].numpy(),
                               np.asarray(want_aux["kl_per_feature"]), rtol=TOL, atol=TOL)
    assert (y_encoder is None) == (jax_y is None)
    if y_encoder is not None:
        y = np.asarray(bundle.y_train[:16])
        y_params = _quick(jax_y.init, jax.random.key(5), jnp.asarray(y))
        y_encoder.load_state_dict(interop.params_from_flax(y_params))
        with torch.no_grad():
            np.testing.assert_allclose(y_encoder(torch.from_numpy(y)).numpy(),
                                       np.asarray(jax_y.apply(y_params, jnp.asarray(y))),
                                       rtol=TOL, atol=TOL)


def test_y_encoder_matches_flax():
    rng = np.random.default_rng(41)
    y = rng.normal(size=(9, 2)).astype(np.float32)
    port = YEncoder(2, (8, 8), 6, num_posenc_frequencies=3,
                    generator=torch.Generator().manual_seed(2))
    flax = JaxYEncoder(hidden=(8, 8), shared_dim=6, num_posenc_frequencies=3)
    want = _quick(flax.apply, interop.params_to_flax(port), jnp.asarray(y))
    with torch.no_grad():
        got = port(torch.from_numpy(y))
    assert got.shape == (9, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    shapes = jax.eval_shape(flax.init, jax.random.key(0), jnp.asarray(y))
    assert jax.tree.map(np.shape, shapes) == jax.tree.map(np.shape, interop.params_to_flax(port))
