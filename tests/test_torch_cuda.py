"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. The file imports nothing of JAX, so it also runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 inputs, 2e-2 for bfloat16 inputs (the JAX
package's Pallas tolerances); the kernel accumulates in float32 in another
order than the plain version.
"""

import pytest
import torch

from dib_tpu_torch.ops import density

F32_TOL = 2e-5
BF16_TOL = 2e-2


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
