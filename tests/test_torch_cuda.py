"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. The file imports nothing of JAX, so it also runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 inputs, 2e-2 for bfloat16 inputs (the JAX
package's Pallas tolerances); the kernels accumulate in float32 in another
order than the plain versions. Attention scores scaled by 100 and
gradients: 1e-4, as the JAX package's flash tests hold them.
"""

import pytest
import torch

from dib_tpu_torch.ops import attention, density

F32_TOL = 2e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, g, n, m, d, diagonal):
    gen = torch.Generator(device=device).manual_seed(0)
    mus = 2.0 * torch.randn(g, m, d, generator=gen, device=device)
    logvars = 0.7 * torch.randn(g, m, d, generator=gen, device=device) - 1.0
    if diagonal:   # u near its own row's mean: the diagonal-dominant regime
        u = mus + torch.randn(g, m, d, generator=gen, device=device) * torch.exp(0.5 * logvars)
    else:
        u = 2.0 * torch.randn(g, n, d, generator=gen, device=device)
    return u, mus, logvars


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,m,d,dtype,diagonal", [
    (10, 1024, 1024, 32, torch.float32, True),     # the slice's shape
    (3, 1000, 1000, 37, torch.float32, True),      # ragged rows, columns and d
    (2, 1, 1, 32, torch.float32, True),            # N = 1: off-diagonal all masked
    (1, 70, 70, 64, torch.float32, True),          # widest supported channel
    (4, 256, 256, 32, torch.bfloat16, True),
    (1, 2000, 512, 32, torch.float32, False),      # probe mode, M != N
])
def test_kernel_matches_plain_version_on_card(cuda_device, g, n, m, d, dtype, diagonal):
    u, mus, logvars = (t.to(dtype) for t in _inputs(cuda_device, g, n, m, d, diagonal))
    before = density.mi_row_stats_launches
    got = density.mi_row_stats(u, mus, logvars, diagonal=diagonal)
    torch.cuda.synchronize()
    assert density.mi_row_stats_launches == before + 1
    want = density.mi_row_stats_reference(u, mus, logvars, diagonal=diagonal)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (g, n)
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    if n == 1:
        assert bool((got[2] == density.NEG_INF).all())


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    u, mus, logvars = _inputs(cuda_device, 2, 16, 16, 8, True)
    before = density.mi_row_stats_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        density.mi_row_stats(u.double(), mus.double(), logvars.double())
    with pytest.raises(ValueError, match="contiguous"):
        density.mi_row_stats(u.transpose(1, 2).contiguous().transpose(1, 2), mus, logvars)
    wide = _inputs(cuda_device, 1, 4, 4, density.MAX_DIM + 1, True)
    with pytest.raises(ValueError, match="d <= 64"):
        density.mi_row_stats(*wide)
    assert density.mi_row_stats_launches == before


def _qkv(device, batch, seq, heads, dim, dtype=torch.float32, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn(batch, seq, heads, dim, generator=gen, device=device)
               for _ in range(3))
    return (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,dim,dtype,scale,tol", [
    (32, 50, 12, 128, torch.float32, 1.0, F32_TOL),     # the flagship's shape
    (4, 1024, 12, 128, torch.float32, 1.0, F32_TOL),    # the automatic regime
    (2, 37, 3, 128, torch.float32, 1.0, F32_TOL),       # ragged key and query tiles
    (2, 1, 2, 128, torch.float32, 1.0, F32_TOL),        # one key
    (3, 70, 5, 16, torch.float32, 1.0, F32_TOL),        # narrow heads
    (2, 1024, 4, 128, torch.bfloat16, 1.0, BF16_TOL),
    (2, 64, 3, 128, torch.float32, 100.0, GRAD_TOL),    # huge scores stay finite
])
def test_flash_kernel_matches_plain_version_on_card(cuda_device, batch, seq, heads, dim, dtype,
                                                    scale, tol):
    q, k, v = _qkv(cuda_device, batch, seq, heads, dim, dtype, scale)
    before = attention.flash_attention_launches
    got = attention.flash_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, attention.flash_self_attention_reference(q, k, v),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs(cuda_device):
    """The fused-QKV layout: q, k, v are strided views of one [B, S, 3, H, D]."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn(4, 50, 3, 12, 128, generator=gen, device=cuda_device)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    got = attention.flash_self_attention(q, k, v)
    want = attention.flash_self_attention_reference(q, k, v)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1024, 37])
def test_flash_gradients_match_plain_autograd_on_card(cuda_device, seq):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda_device, 2, seq, 4, 128))
    attention.flash_self_attention(q, k, v).square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention.flash_self_attention_reference(q, k, v).square().sum().backward()
    for g, t in zip(got, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.cuda
def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 8, 2, 16)
    before = attention.flash_attention_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.flash_self_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="of one type"):
        attention.flash_self_attention(q, k.bfloat16(), v)
    wide = _qkv(cuda_device, 1, 8, 1, attention.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="D <= 128"):
        attention.flash_self_attention(*wide)
    strided = q.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="unit stride"):
        attention.flash_self_attention(strided, k, v)
    assert attention.flash_attention_launches == before
