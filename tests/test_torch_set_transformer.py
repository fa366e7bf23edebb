"""The port's set transformer and per-particle model vs the JAX package's
Flax models, with the JAX weights carried over through
``dib_tpu_torch.interop`` and the same numpy-seeded inputs and noise.

Tolerance 2e-5: float32 matmuls in another order, and LayerNorm, whose
variance Flax takes as E[x^2] - E[x]^2 and PyTorch as E[(x - mean)^2]
(a few 1e-7 per block, through two blocks and the head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.models.per_particle import PerParticleDIBModel as JaxPerParticle
from dib_tpu.models.set_transformer import SetTransformer as JaxSetTransformer
from dib_tpu_torch import interop
from dib_tpu_torch.models import PerParticleDIBModel, SetTransformer
from dib_tpu_torch.models import set_transformer as set_transformer_module

torch.set_num_threads(1)

TOL = 2e-5
TINY = dict(num_blocks=2, num_heads=2, key_dim=8, ff_hidden=(8,), head_hidden=(8,))
TINY_PARTICLES = dict(num_particles=8, encoder_hidden=(8,), embedding_dim=4, **TINY)
FLAGSHIP_PARAMS = 1_293_505


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _port(cls, flax_params, **kwargs):
    model = cls(**kwargs, device="cpu", generator=torch.Generator().manual_seed(5))
    model.load_state_dict(interop.params_from_flax(jax.device_get(flax_params)))
    return model


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_set_transformer_matches_jax(fuse_qkv, use_flash):
    x = np.random.default_rng(0).standard_normal((3, 8, 4)).astype(np.float32)
    jax_model = JaxSetTransformer(model_dim=4, fuse_qkv=fuse_qkv, use_flash=use_flash, **TINY)
    params = jax_model.init(jax.random.key(1), jnp.asarray(x))
    model = _port(SetTransformer, params, model_dim=4, fuse_qkv=fuse_qkv, use_flash=use_flash,
                  **TINY)
    _close(model(torch.from_numpy(x)), jax_model.apply(params, jnp.asarray(x)))
    # the Flax tree goes back unchanged
    back = interop.params_to_flax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.device_get(params))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_per_particle_model_matches_jax(fuse_qkv, use_flash):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8 * 12)).astype(np.float32)
    jax_model = JaxPerParticle(fuse_qkv=fuse_qkv, use_flash=use_flash, **TINY_PARTICLES)
    key = jax.random.key(3)
    params = jax_model.init(jax.random.key(4), jnp.asarray(x), key)
    model = _port(PerParticleDIBModel, params, fuse_qkv=fuse_qkv, use_flash=use_flash,
                  **TINY_PARTICLES)
    # the JAX model's own noise, injected: reparameterize draws normal(key, [B, P, d])
    eps = jax.random.normal(key, model.noise_shape(3), jnp.float32)
    for sample in (True, False):
        want_pred, want_aux = jax_model.apply(params, jnp.asarray(x), key, sample=sample)
        pred, aux = model(torch.from_numpy(x), eps=torch.from_numpy(np.array(eps)),
                          sample=sample)
        _close(pred, want_pred)
        for name in ("kl_per_feature", "mus", "logvars", "embeddings"):
            assert aux[name].shape == want_aux[name].shape, name
            _close(aux[name], want_aux[name])
    mus, logvars = model.encode(torch.from_numpy(x))
    want_mus, want_logvars = jax_model.encode(params, jnp.asarray(x))
    _close(mus, want_mus)
    _close(logvars, want_logvars)
    one = x.reshape(3, 8, 12)[:, 5]
    got = model.encode_feature(5, torch.from_numpy(one))
    want = jax_model.encode_feature(params, 5, jnp.asarray(one))
    for g, w in zip(got, want):
        _close(g, w)


def test_flagship_parameter_tree_matches_jax():
    """Names, shapes and count of the full-width model, from the Flax
    model's abstract init."""
    x = jnp.zeros((2, 50 * 12), jnp.float32)
    shapes = jax.eval_shape(JaxPerParticle().init, jax.random.key(0), x, jax.random.key(1))
    want = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = PerParticleDIBModel(device="cpu", generator=torch.Generator().manual_seed(0))
    got = {"/".join(str(k.key) for k in path): leaf.shape
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               interop.params_to_flax(model))[0]}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == FLAGSHIP_PARAMS
    assert sum(int(np.prod(s)) for s in want.values()) == FLAGSHIP_PARAMS


def test_remat_gives_the_same_gradients():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 8, 4)).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = SetTransformer(model_dim=4, remat=remat, device="cpu",
                               generator=torch.Generator().manual_seed(0), **TINY)
        model(x).sum().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_attention_dispatch_rule(monkeypatch):
    calls = []

    def fake_flash(q, k, v):
        calls.append(q.shape[1])
        return set_transformer_module.dense_self_attention(q, k, v)

    monkeypatch.setattr(set_transformer_module, "flash_self_attention", fake_flash)
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(1, 16, 4)
    auto = SetTransformer(model_dim=4, flash_min_seq=16, device="cpu", generator=gen, **TINY)
    auto(x)
    assert calls == []                 # auto: large sets go to the kernel only on the GPU
    forced = SetTransformer(model_dim=4, use_flash=True, device="cpu", generator=gen, **TINY)
    forced(x)
    assert calls == [16, 16]           # one call per block
    block = auto.blocks[0].attention
    assert not block.flash(x)
    assert block.flash(torch.zeros(1, 16, 4, device="meta")) is False
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert block.flash(x) and not block.flash(x[:, :15])


def test_models_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerParticleDIBModel(**TINY_PARTICLES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SetTransformer(model_dim=4, **TINY)
