"""The port's bfloat16 compute (``compute_dtype='bfloat16'``) against the JAX
package's, on the CPU.

Both packages get the same parameters (carried across through ``interop`` or
by name), the same numpy-seeded inputs and the same noise. Every comparison
is held two ways (``_hold``):

  - to BF16_TOL (2e-2) as atol = rtol against JAX in bfloat16;
  - by its mean absolute error against JAX in bfloat16, which must be at most
    a quarter of the mean absolute difference between JAX in bfloat16 and JAX
    in float32 on the same inputs. So agreement means the same rounding
    points (Flax rounds ``x @ W`` to bfloat16, then adds a bfloat16 bias; a
    weakly typed constant such as the attention scale or the leaky slope is
    rounded to bfloat16 before it multiplies), not merely bfloat16-sized
    agreement.

The JAX functions are compiled with ``xla_allow_excess_precision`` off
(``_compiled``), so each primitive rounds to its output type as the jaxpr
says (and as JAX run op by op rounds): by default XLA's CPU compiler drops
float32 -> bfloat16 -> float32 round trips inside the backward pass, which
moves a feed-forward kernel's gradient by up to 2.3 x the bf16-vs-f32
spread.

Gradients are held to the quarter rule over the whole gradient and per leaf,
except the biases of bfloat16 layers and the attention key bias. A bfloat16
layer's bias gradient is the sum over the batch of a bfloat16 cotangent:
XLA's CPU backend accumulates that ``reduce_sum`` in bfloat16, PyTorch in
float32 with one rounding at the end, so those leaves differ by bfloat16
noise, at most 1.3 x the bf16-vs-f32 spread in these runs; each is held to
twice that spread. The key bias has a zero gradient in exact arithmetic
(``test_torch_train.py``), so it is noise in every recipe and is left to
the whole-gradient rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.data import get_dataset as jax_get_dataset
from dib_tpu.models import MLP as JaxMLP
from dib_tpu.models import DistributedIBModel as JaxDIB
from dib_tpu.models.encoders import GaussianEncoder as JaxGaussianEncoder
from dib_tpu.models.per_particle import PerParticleDIBModel as JaxPerParticle
from dib_tpu.models.set_transformer import SetTransformer as JaxSetTransformer
from dib_tpu.ops.pallas_attention import flash_self_attention as jax_flash
from dib_tpu.train.losses import resolve_loss as jax_resolve_loss
from dib_tpu_torch import interop
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.models import (
    MLP,
    DistributedIBModel,
    GaussianEncoder,
    PerParticleDIBModel,
    SetTransformer,
)
from dib_tpu_torch.models.mlp import resolve_dtype
from dib_tpu_torch.ops import attention
from dib_tpu_torch.parallel import BetaSweepTrainer
from dib_tpu_torch.train import DIBTrainer, TrainConfig
from dib_tpu_torch.workloads import (
    AmorphousWorkloadConfig,
    run_amorphous_protocols,
    run_amorphous_sweep,
    run_amorphous_workload,
)

torch.set_num_threads(1)

BF16 = "bfloat16"
BF16_TOL = 2e-2           # atol = rtol against JAX in bfloat16
QUARTER = 0.25            # mean error vs JAX-bf16 <= QUARTER x mean |JAX-bf16 - JAX-f32|
BIAS_SPREAD = 2.0         # a bfloat16 layer's bias gradient: <= 2 x that spread
# each primitive rounds to its output type; no LLVM optimisation (a third of the compile time)
STRICT = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
_EXECUTABLES = {}
PARTICLES = dict(num_particles=8, encoder_hidden=(8,), embedding_dim=4, num_blocks=1,
                 num_heads=2, key_dim=8, ff_hidden=(8,), head_hidden=(8,))
DIB = dict(encoder_hidden=(8,), integration_hidden=(8,), output_dim=1, embedding_dim=4)
SETTINGS = dict(learning_rate=1e-3, batch_size=4, beta_start=1e-3, beta_end=1e-1,
                num_pretraining_epochs=0, num_annealing_epochs=2, steps_per_epoch=1,
                max_val_points=16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), dtype=np.float64)


def _hold(name, got, want_bf16, want_f32, tol=BF16_TOL, rounded=True):
    """The module's two rules: ``tol`` against JAX-bf16 (elementwise, when
    given), and the mean error at most QUARTER of JAX's own bf16-vs-f32
    spread, which must not be 0 when ``rounded`` (bfloat16 changed
    something). Returns (error, spread)."""
    got, jb, jf = _np(got), _np(want_bf16), _np(want_f32)
    assert got.shape == jb.shape == jf.shape, (name, got.shape, jb.shape, jf.shape)
    if tol is not None:
        np.testing.assert_allclose(got, jb, rtol=tol, atol=tol, err_msg=name)
    err, spread = np.abs(got - jb).mean(), np.abs(jb - jf).mean()
    assert spread > 0 or not rounded, f"{name}: bfloat16 rounded nothing"
    assert err <= QUARTER * spread, f"{name}: mean error {err:.3e}, bf16-vs-f32 {spread:.3e}"
    return err, spread


def _compiled(name, fn, *args):
    """``fn(*args)`` compiled with STRICT options, the executable kept under
    ``name`` for the module's later calls with arguments of the same shapes."""
    if name not in _EXECUTABLES:
        _EXECUTABLES[name] = jax.jit(fn).lower(*args).compile(compiler_options=STRICT)
    return _EXECUTABLES[name](*args)


def _bf16_bias(path: str) -> bool:
    """A bias of a bfloat16 Dense/DenseGeneral layer (not a LayerNorm's)."""
    return path.endswith("bias") and "LayerNorm" not in path


def _hold_gradients(got: dict, want_bf16: dict, want_f32: dict):
    """Flax-path -> array trees of gradients: the quarter rule over the whole
    gradient and per leaf, the bfloat16 biases to BIAS_SPREAD x the spread."""
    paths = sorted(want_bf16)
    assert sorted(got) == paths == sorted(want_f32)
    flat = [np.concatenate([_np(t[p]).ravel() for p in paths]) for t in (got, want_bf16, want_f32)]
    _hold("whole gradient", *flat, tol=None)
    for path in paths:
        if path.endswith("key/bias"):
            continue
        g, jb, jf = _np(got[path]), _np(want_bf16[path]), _np(want_f32[path])
        if _bf16_bias(path):
            err, spread = np.abs(g - jb).mean(), np.abs(jb - jf).mean()
            assert err <= BIAS_SPREAD * spread, (path, err, spread)
        else:
            _hold(path, g, jb, jf, tol=None, rounded=False)     # a dead unit's leaf is 0
            assert np.linalg.norm(g - jb) <= BF16_TOL * np.linalg.norm(jb) + 1e-7, path


def _flax_paths(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_grads(model) -> dict:
    return _flax_paths(interop.params_to_flax(
        {name: p.grad for name, p in model.named_parameters()}))


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("stack,activation,output_dtype", [
    (None, "leaky_relu", None),
    (3, "relu", "float32"),         # a sweep's stack, the encoders' float32 output layer
    # the CLI's --activation_fn: each rounds where XLA rounds (gelu and
    # sigmoid after each of their operations)
    (None, "gelu", None),
    (None, "tanh", None),
    (None, "sigmoid", None),
    (3, "gelu", "float32"),
])
def test_mlp_bf16_matches_flax(stack, activation, output_dtype):
    rng = np.random.default_rng(30)
    lead = () if stack is None else (stack,)
    h = rng.normal(size=lead + (5, 7, 6)).astype(np.float32)
    mlp = MLP(6, (16, 9), 3, activation, stack=stack, dtype=BF16, output_dtype=output_dtype,
              generator=torch.Generator().manual_seed(0))
    params = {f"Dense_{i}": {leaf: getattr(layer, leaf).detach().numpy()
                             for leaf in ("kernel", "bias")}
              for i, layer in enumerate(mlp.layers)}
    got = mlp(torch.from_numpy(h))
    assert mlp.layers[0].kernel.dtype == torch.float32
    assert got.dtype == (torch.float32 if output_dtype else torch.bfloat16)
    want = {}
    for dtype in (BF16, None):
        flax_mlp = JaxMLP(hidden=(16, 9), output_dim=3, activation=activation, dtype=dtype,
                          output_dtype=output_dtype if dtype else None)

        def apply(p, x, flax_mlp=flax_mlp):
            return flax_mlp.apply({"params": p}, x)

        want[dtype] = _compiled(f"mlp {stack} {activation} {dtype}", apply if stack is None
                                else jax.vmap(apply), params, jnp.asarray(h))
    assert want[BF16].dtype == (jnp.float32 if output_dtype else jnp.bfloat16)
    _hold("MLP", got, want[BF16], want[None])


def test_gaussian_encoder_bf16_matches_flax():
    """Hidden layers in bfloat16, the final layer float32 on the bfloat16
    hidden state: float32 mus and logvars."""
    rng = np.random.default_rng(31)
    x = rng.uniform(-1, 1, size=(6, 3)).astype(np.float32)
    encoder = GaussianEncoder(3, (16, 8), 4, num_posenc_frequencies=2, logvar_offset=-1.0,
                              compute_dtype=BF16, generator=torch.Generator().manual_seed(1))
    params = {"MLP_0": {f"Dense_{i}": {leaf: getattr(layer, leaf).detach().numpy()
                                       for leaf in ("kernel", "bias")}
                        for i, layer in enumerate(encoder.mlp.layers)}}
    mus, logvars = encoder(torch.from_numpy(x))
    assert mus.dtype == logvars.dtype == torch.float32
    want = {dtype: _compiled(f"encoder {dtype}", JaxGaussianEncoder(
        (16, 8), 4, num_posenc_frequencies=2, logvar_offset=-1.0, compute_dtype=dtype).apply,
        {"params": params}, jnp.asarray(x)) for dtype in (BF16, None)}
    for i, name in enumerate(("mus", "logvars")):
        _hold(name, (mus, logvars)[i], want[BF16][i], want[None][i])


@pytest.mark.parametrize("num_blocks,use_flash", [(2, False)])
def test_set_transformer_bf16_matches_flax(num_blocks, use_flash):
    """Projections, attention core and feed-forward in bfloat16; residuals,
    LayerNorms, the mean pool and the logits in float32. (The flash core's
    bfloat16 numerics are held on their own below.)"""
    config = dict(num_blocks=num_blocks, num_heads=2, key_dim=8, model_dim=4, ff_hidden=(8,),
                  head_hidden=(8,), output_dim=2, use_flash=use_flash)
    model = SetTransformer(**config, compute_dtype=BF16, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    x = np.random.default_rng(32).normal(size=(3, 10, 4)).astype(np.float32)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    params = interop.params_to_flax(model)
    want = {dtype: _compiled(f"set transformer {num_blocks} {dtype}", JaxSetTransformer(
        **config, compute_dtype=dtype).apply, params, jnp.asarray(x)) for dtype in (BF16, None)}
    assert want[BF16].dtype == jnp.float32
    _hold("logits", got, want[BF16], want[None])


# -------------------------------------------------------------- models, steps

@pytest.fixture(scope="module")
def bundles():
    """(port, JAX) bundles: 8-particle amorphous sets, the boolean circuit."""
    return {"per_particle": (get_dataset("amorphous_particles", number_particles_to_use=8,
                                         num_synthetic_neighborhoods=64),
                             jax_get_dataset("amorphous_particles", number_particles_to_use=8,
                                             num_synthetic_neighborhoods=64)),
            "dib": (get_dataset("boolean_circuit"), jax_get_dataset("boolean_circuit"))}


def _model(kind, bundle, compute_dtype=BF16, **kwargs):
    """(port model, JAX model of a compute dtype) of one tiny configuration;
    dense attention (the flash path's bfloat16 numerics are held on their
    own below, and its forward inside a model by the set transformer test)."""
    if kind == "per_particle":
        return (PerParticleDIBModel(**PARTICLES, compute_dtype=compute_dtype, device="cpu",
                                    **kwargs),
                lambda dtype: JaxPerParticle(**PARTICLES, compute_dtype=dtype))
    dims = tuple(bundle.feature_dimensionalities)
    return (DistributedIBModel(dims, **DIB, compute_dtype=compute_dtype, device="cpu", **kwargs),
            lambda dtype: JaxDIB(feature_dimensionalities=dims, **DIB, compute_dtype=dtype))


def _jax_loss(jax_model, loss_name, noise_shape):
    """``dib_tpu``'s ``DIBTrainer._forward_loss`` (supervised), also
    returning the prediction, the model's aux and the noise the model drew
    from ``key`` (``reparameterize``'s normal of the channels' shape), as
    value and gradient."""
    task_loss = jax_resolve_loss(loss_name)

    def loss(params, x, y, beta, key):
        prediction, aux = jax_model.apply(params["model"], x, key)
        task = task_loss(prediction, y)
        eps = jax.random.normal(key, noise_shape, jnp.float32)
        return task + beta * jnp.sum(aux["kl_per_feature"]), (task, prediction, aux, eps)

    return jax.value_and_grad(loss, has_aux=True)


@pytest.mark.parametrize("kind", ["per_particle", "dib"])
def test_model_and_trainer_step_bf16_match_jax(bundles, kind):
    """One ``DIBTrainer.train_step`` of a bfloat16 model against JAX's loss
    and gradients on the same weights, batch and noise; the forward's
    prediction, channel parameters and KL too, all float32."""
    bundle, jax_bundle = bundles[kind]
    model, jax_model = _model(kind, bundle, generator=torch.Generator().manual_seed(3))
    params = {"model": interop.params_to_flax(model)}
    rows = np.random.default_rng(33).integers(0, len(bundle.x_train), size=4)
    x, y = bundle.x_train[rows], bundle.y_train[rows]
    beta = 0.05
    want = {dtype: _compiled(f"{kind} step {dtype}",
                             _jax_loss(jax_model(dtype), jax_bundle.loss, model.noise_shape(4)),
                             params, jnp.asarray(x), jnp.asarray(y), beta, jax.random.key(34))
            for dtype in (BF16, None)}
    eps = np.array(want[BF16][0][1][3])

    with torch.no_grad():
        prediction, aux = model(torch.from_numpy(x), eps=torch.from_numpy(eps))
    trainer = DIBTrainer(model, bundle, TrainConfig(**SETTINGS), device="cpu")
    state, _ = trainer.init()
    stats = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(y), beta,
                               torch.from_numpy(eps))
    for tensor in (prediction, aux["mus"], aux["logvars"], aux["kl_per_feature"],
                   stats["task"], stats["kl"]):
        assert tensor.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    (_, (task_b, pred_b, aux_b, _)), grads_b = want[BF16]
    (_, (task_f, pred_f, aux_f, _)), grads_f = want[None]
    _hold("prediction", prediction, pred_b, pred_f)
    for name in ("mus", "logvars"):
        _hold(name, aux[name], aux_b[name], aux_f[name])
    _hold("kl_per_feature", stats["kl"], aux_b["kl_per_feature"], aux_f["kl_per_feature"])
    _hold("task loss", stats["task"], task_b, task_f)
    _hold_gradients(_port_grads(model), _flax_paths(grads_b["model"]),
                    _flax_paths(grads_f["model"]))


def test_sweep_step_bf16_matches_jax(bundles):
    """One ``BetaSweepTrainer.train_step`` of 2 bfloat16 replicas against
    the JAX sweep's step, which is its serial loss vmapped over the replica
    axis: each replica's loss and gradients against the serial JAX loss on
    that replica's weights, batch, noise and beta (vmap moves no rounding)."""
    bundle, jax_bundle = bundles["per_particle"]
    replicas, betas = 2, np.array([1e-3, 1e-1], np.float32)
    model, jax_model = _model("per_particle", bundle, replicas=replicas,
                              generator=[torch.Generator().manual_seed(s) for s in (5, 6)])
    rows = np.random.default_rng(35).integers(0, len(bundle.x_train), size=(replicas, 4))
    x, y = bundle.x_train[rows], bundle.y_train[rows]
    want = [{dtype: _compiled(f"per_particle step {dtype}",
                              _jax_loss(jax_model(dtype), jax_bundle.loss, model.noise_shape(4)[1:]),
                              {"model": interop.params_to_flax(model, replica=r)},
                              jnp.asarray(x[r]), jnp.asarray(y[r]), float(betas[r]),
                              jax.random.key(36 + r)) for dtype in (BF16, None)}
            for r in range(replicas)]
    eps = np.stack([np.array(w[BF16][0][1][3]) for w in want])
    sweep = BetaSweepTrainer(model, bundle, TrainConfig(**SETTINGS), 1e-3, (1e-2, 1e-1),
                             device="cpu")
    states, _ = sweep.init()
    stats = sweep.train_step(states, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(betas), torch.from_numpy(eps))
    grads = _port_grads(model)
    for r in range(replicas):
        (_, (task_b, _, aux_b, _)), grads_b = want[r][BF16]
        (_, (task_f, _, aux_f, _)), grads_f = want[r][None]
        _hold(f"replica {r} task loss", stats["task"][r], task_b, task_f)
        _hold(f"replica {r} KL", stats["kl"][r], aux_b["kl_per_feature"], aux_f["kl_per_feature"])
        _hold_gradients({path: g[r] for path, g in grads.items()},
                        _flax_paths(grads_b["model"]), _flax_paths(grads_f["model"]))


def test_flash_bf16_reference_and_backward_match_jax():
    """The flash kernel's plain version (what a CPU tensor takes) and its
    blocked-recompute backward on bfloat16 q, k, v, against the Pallas kernel
    in interpret mode: float32 output, gradients in bfloat16 (the input type,
    as ``_flash_bwd_rule`` casts back)."""
    rng = np.random.default_rng(37)
    q, k, v = (rng.normal(size=(2, 50, 2, 16)).astype(np.float32) for _ in range(3))
    w = rng.normal(size=(2, 50, 2, 16)).astype(np.float32)     # a cotangent

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v) * w)

    def forward_and_grad(q, k, v):
        return jax_flash(q, k, v), jax.grad(loss, (0, 1, 2))(q, k, v)

    want = {dtype: _compiled(f"flash {dtype}", forward_and_grad,
                             *(jnp.asarray(t).astype(dtype) for t in (q, k, v)))
            for dtype in (jnp.bfloat16, jnp.float32)}
    leaves = [torch.from_numpy(t).bfloat16().requires_grad_() for t in (q, k, v)]
    out = attention.flash_self_attention(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.dtype == torch.float32 and want[jnp.bfloat16][0].dtype == jnp.float32
    _hold("flash output", out, want[jnp.bfloat16][0], want[jnp.float32][0])
    for name, leaf, gb, gf in zip("qkv", leaves, want[jnp.bfloat16][1], want[jnp.float32][1]):
        assert leaf.grad.dtype == torch.bfloat16 and gb.dtype == jnp.bfloat16
        _hold(f"d{name}", leaf.grad, gb, gf)
    grads = attention.flash_attention_backward(*(t.detach() for t in leaves),
                                               torch.from_numpy(w))
    for leaf, grad in zip(leaves, grads):
        assert grad.dtype == torch.bfloat16 and torch.equal(grad, leaf.grad)


# ------------------------------------------------------------------ contract

def test_bf16_dtype_contract():
    """Parameters stay float32 and the precision-critical outputs (logits,
    mus, logvars, KL) are float32, with and without replicas; ``carve`` keeps
    the compute type; ``None`` and 'float32' compute exactly what the
    default model computes."""
    rng = np.random.default_rng(38)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8 * 12)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(2, 3, 8, 4)).astype(np.float32))
    gens = [torch.Generator().manual_seed(s) for s in (7, 8)]
    sweep_model = PerParticleDIBModel(**PARTICLES, compute_dtype=BF16, replicas=2,
                                      generator=gens, device="cpu")
    dib = DistributedIBModel((2, 1, 3), **DIB, compute_dtype=torch.bfloat16, device="cpu",
                             generator=torch.Generator().manual_seed(9))
    outputs = [sweep_model(x, eps=eps), sweep_model.carve(1)(x[1], eps=eps[1]),
               dib(x[0, :, :6])]
    for prediction, aux in outputs:
        for tensor in (prediction, aux["mus"], aux["logvars"], aux["kl_per_feature"]):
            assert tensor.dtype == torch.float32 and torch.isfinite(tensor).all()
    for model in (sweep_model, dib):
        assert all(p.dtype == torch.float32 for p in model.parameters())
    carved = sweep_model.carve(1)
    assert carved.architecture["compute_dtype"] == BF16
    assert carved.aggregator.blocks[0].attention.query.dtype == torch.bfloat16
    torch.testing.assert_close(outputs[1][0], outputs[0][0][1], rtol=1e-6, atol=1e-6)
    mus, logvars = sweep_model.encode_feature(0, x[0, :, :12])     # [N, F] -> [R, N, d]
    assert mus.shape == logvars.shape == (2, 3, 4) and mus.dtype == torch.float32
    torch.testing.assert_close(mus[1], carved.encode_feature(0, x[0, :, :12])[0])
    base = PerParticleDIBModel(**PARTICLES, device="cpu", generator=torch.Generator().manual_seed(7))
    want = base(x[0], eps=eps[0])[0]
    for compute_dtype in (None, "float32"):
        model = PerParticleDIBModel(**PARTICLES, compute_dtype=compute_dtype, device="cpu",
                                    generator=torch.Generator().manual_seed(7))
        assert torch.equal(model(x[0], eps=eps[0])[0], want)


def test_resolve_dtype_names_and_cublas_reduction():
    assert resolve_dtype(None) is None
    assert resolve_dtype("float32") is torch.float32
    assert resolve_dtype(torch.bfloat16) is torch.bfloat16
    for bad in ("int32", "bf17"):
        with pytest.raises(ValueError):
            resolve_dtype(bad)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    assert resolve_dtype("bfloat16") is torch.bfloat16
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


def test_parameter_trees_do_not_change_with_compute_dtype():
    """A Flax tree is the same with and without ``compute_dtype``, so one
    interop serves both: a bfloat16 port model maps to the JAX bfloat16
    model's tree (paths, shapes, float32) and loads it back strictly."""
    x = jnp.zeros((2, 8 * 12), jnp.float32)
    trees = {dtype: _flax_paths(jax.eval_shape(
        JaxPerParticle(**PARTICLES, compute_dtype=dtype).init, jax.random.key(0), x,
        jax.random.key(1))) for dtype in (BF16, None)}
    assert {p: (s.shape, s.dtype) for p, s in trees[BF16].items()} == \
        {p: (s.shape, s.dtype) for p, s in trees[None].items()}
    model = PerParticleDIBModel(**PARTICLES, compute_dtype=BF16, device="cpu",
                                generator=torch.Generator().manual_seed(10))
    tree = interop.params_to_flax(model)
    assert {p: (a.shape, a.dtype) for p, a in _flax_paths(tree).items()} == \
        {p: (s.shape, jnp.float32) for p, s in trees[BF16].items()}
    model.load_state_dict(interop.params_from_flax(tree), strict=True)


@pytest.mark.parametrize("driver", ["workload", "protocols", "sweep"])
def test_drivers_take_compute_dtype(driver):
    """``model_overrides={'compute_dtype': 'bfloat16'}`` reaches the model
    of each amorphous driver; a few tiny steps stay finite."""
    config = AmorphousWorkloadConfig(num_steps=4, batch_size=4, number_particles=8,
                                     warmup_steps=2, eval_every=2, mi_eval_batch_size=8,
                                     mi_eval_batches=1)
    overrides = dict(encoder_hidden=(8,), embedding_dim=4, num_blocks=1, num_heads=2,
                     key_dim=8, ff_hidden=(8,), head_hidden=(8,), compute_dtype=BF16)
    common = dict(device="cpu", render=False, model_overrides=overrides,
                  num_synthetic_neighborhoods=64)
    if driver == "sweep":
        result = run_amorphous_sweep(0, config, beta_ends=(1e-2, 1e-1), steps_per_epoch=2,
                                     chunk_epochs=1, **common)
        model, losses = result["states"].params["model"], [r.loss for r in result["records"]]
    else:
        if driver == "workload":
            result = run_amorphous_workload(0, config, probe_maps=False, **common)
        else:
            result = run_amorphous_protocols(0, ("GradualQuench",), config, probe_maps=False,
                                             **common)["GradualQuench"]
        model, losses = result["state"].params["model"], [result["history"].loss]
    assert model.architecture["compute_dtype"] == BF16
    assert model.aggregator.blocks[0].ff.layers[0].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(loss).all() for loss in losses)
