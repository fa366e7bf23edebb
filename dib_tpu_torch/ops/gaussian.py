"""Diagonal-Gaussian bottleneck math (counterpart of ``dib_tpu/ops/gaussian.py``)."""

from __future__ import annotations

import torch

_LOG_2PI = 1.8378770664093453  # log(2*pi)


def kl_diagonal_gaussian(mus: torch.Tensor, logvars: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """KL( N(mu, diag(exp(logvar))) || N(0, I) ), summed over ``dim``, in nats."""
    return 0.5 * torch.sum(mus.square() + logvars.exp() - logvars - 1.0, dim=dim)


def reparameterize(mus: torch.Tensor, logvars: torch.Tensor,
                   generator: torch.Generator | None = None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """Sample u ~ N(mu, diag(exp(logvar))) with the reparameterization trick.

    ``eps`` (standard-normal noise of the same shape) replaces the draw, so
    tests can feed both packages the same noise; otherwise it is drawn from
    ``generator``, which must live on the tensors' device.
    """
    if eps is None:
        eps = torch.randn(mus.shape, generator=generator, dtype=mus.dtype, device=mus.device)
    return mus + eps * torch.exp(0.5 * logvars)


def gaussian_log_density_mat(u: torch.Tensor, mus: torch.Tensor,
                             logvars: torch.Tensor) -> torch.Tensor:
    """Log density matrix ``log p(u_i | x_j)`` for diagonal Gaussians.

    ``u`` is [..., N, d], ``mus``/``logvars`` [..., M, d]; returns [..., N, M].
    The quadratic term uses the direct difference, never the norm-expansion
    matmul: on the diagonal u ~= mu and ||u||^2 + ||mu||^2 - 2 u.mu cancels.
    """
    diff = u[..., :, None, :] - mus[..., None, :, :]             # [..., N, M, d]
    inv_var = torch.exp(-logvars)[..., None, :, :]                # [..., 1, M, d]
    quad = torch.sum(diff * diff * inv_var, dim=-1)               # [..., N, M]
    log_norm = torch.sum(logvars, dim=-1)[..., None, :]           # [..., 1, M]
    d = u.shape[-1]
    return -0.5 * (quad + log_norm + d * _LOG_2PI)
