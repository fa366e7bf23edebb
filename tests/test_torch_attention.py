"""The port's attention functions vs the JAX package's, on the same
numpy-seeded inputs.

The JAX flash kernel runs in Pallas interpret mode (its default off a TPU);
on CPU tensors the port's ``flash_self_attention`` takes its plain version
and its autograd backward, the blocked recompute.

Tolerances: 1e-5 in float32 (the same sums in another order, blockwise in
JAX and in one pass here); 1e-4 for scores scaled by 100 and for gradients
(the JAX package's own flash tolerances); 1e-2 for bfloat16 inputs (one
bfloat16 rounding of p or of the scores, at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.ops.pallas_attention import flash_self_attention as jax_flash
from dib_tpu.parallel.context import dense_self_attention as jax_dense
from dib_tpu_torch.ops import attention
from dib_tpu_torch.ops.attention import (
    dense_self_attention,
    flash_attention_backward,
    flash_self_attention,
    flash_self_attention_reference,
)

torch.set_num_threads(1)

F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-2
BLOCK = 32          # JAX flash blocks: S = 37 and 64 span two key blocks


def _qkv(seq, batch=2, heads=3, dim=16, seed=0, scale=(1.0, 1.0, 1.0)):
    rng = np.random.default_rng(seed)
    return tuple(s * rng.standard_normal((batch, seq, heads, dim)).astype(np.float32)
                 for s in scale)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seq", [8, 37, 64])
def test_flash_matches_jax_flash(seq):
    q, k, v = _qkv(seq)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=BLOCK, block_k=BLOCK)
    before = attention.flash_attention_launches
    got = flash_self_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert attention.flash_attention_launches == before   # CPU: the plain version
    _close(got, want, F32_TOL)


def test_flash_large_scores_stay_finite():
    q, k, v = _qkv(64, scale=(100.0, 100.0, 1.0))
    want = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=BLOCK, block_k=BLOCK)
    got = flash_self_attention(*map(torch.from_numpy, (q, k, v)))
    assert bool(torch.isfinite(got).all())
    _close(got, want, GRAD_TOL)


def test_flash_gradients_match_jax():
    q, k, v = _qkv(37, heads=2, dim=8)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, block_q=16, block_k=16) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_self_attention(tq, tk, tv).square().sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, GRAD_TOL)
    # the blocked recompute with a ragged last query block gives the same
    out = flash_self_attention_reference(*map(torch.from_numpy, (q, k, v)))
    blocked = flash_attention_backward(*map(torch.from_numpy, (q, k, v)), 2 * out, block_q=16)
    for got, w in zip(blocked, want):
        _close(got, w, GRAD_TOL)


@pytest.mark.parametrize("seq,dim", [(8, 16), (37, 16), (64, 16), (37, 128)])
def test_flash_bfloat16_matches_jax_flash(seq, dim):
    q, k, v = _qkv(seq, dim=dim)
    want = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     block_q=BLOCK, block_k=BLOCK)
    got = flash_self_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.float32
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_jax_dense(monkeypatch, dtype, score_dtype):
    monkeypatch.setenv("DIB_ATTN_SCORE_DTYPE", score_dtype)
    q, k, v = _qkv(37, seed=1)
    want = jax_dense(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    got = dense_self_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                 for a in (q, k, v)))
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_dense_score_dtype_rejects_unknown_names(monkeypatch):
    monkeypatch.setenv("DIB_ATTN_SCORE_DTYPE", "float16")
    q = torch.zeros(1, 2, 1, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="DIB_ATTN_SCORE_DTYPE"):
        dense_self_attention(q, q, q)


def test_flash_wrapper_checks_its_inputs():
    q = torch.zeros(2, 5, 3, 8)
    with pytest.raises(ValueError, match="one shape"):
        flash_self_attention(q, q[:, :4], q)
    with pytest.raises(ValueError, match="one shape"):
        flash_self_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_self_attention(*(t.to("meta") for t in (q, q, q)))


def test_flash_reference_equals_dense_in_float32():
    """The two recipes (scale before vs after the product) agree in float32."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(50, seed=2))
    _close(flash_self_attention_reference(q, k, v), dense_self_attention(q, k, v).numpy(),
           F32_TOL)
