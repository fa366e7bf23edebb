"""Diagonal-Gaussian bottleneck math (counterpart of ``dib_tpu/ops/gaussian.py``): KL,
sampling, the log-density matrix, and the pairwise Bhattacharyya and KL
matrices the compression schemes read (plain PyTorch; the JAX package
computes them in XLA, with no Pallas kernel)."""

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


def bhattacharyya_dist_mat(mus1: torch.Tensor, logvars1: torch.Tensor, mus2: torch.Tensor,
                           logvars2: torch.Tensor) -> torch.Tensor:
    """Pairwise Bhattacharyya distances between diagonal Gaussians: [N, d]
    and [M, d] parameters -> [N, M].

        D_B = 1/8 sum_d (mu1 - mu2)^2 / sigma_bar
            + 1/2 sum_d (log sigma_bar - (logvar1 + logvar2) / 2)

    with sigma_bar = (var1 + var2) / 2 per dimension.
    """
    var1 = torch.exp(logvars1)[:, None, :]                        # [N, 1, d]
    var2 = torch.exp(logvars2)[None, :, :]                        # [1, M, d]
    sigma_bar = 0.5 * (var1 + var2)                               # [N, M, d]
    diff = mus1[:, None, :] - mus2[None, :, :]
    term1 = 0.125 * torch.sum(diff * diff / sigma_bar, dim=-1)
    term2 = 0.5 * torch.sum(
        torch.log(sigma_bar) - 0.5 * (logvars1[:, None, :] + logvars2[None, :, :]), dim=-1)
    return term1 + term2


def kl_divergence_mat(mus1: torch.Tensor, logvars1: torch.Tensor, mus2: torch.Tensor,
                      logvars2: torch.Tensor) -> torch.Tensor:
    """Pairwise KL( N_i(mu1, var1) || N_j(mu2, var2) ) in nats between
    diagonal Gaussians: [N, d] and [M, d] parameters -> [N, M]."""
    var1 = torch.exp(logvars1)[:, None, :]
    inv_var2 = torch.exp(-logvars2)[None, :, :]
    diff = mus2[None, :, :] - mus1[:, None, :]
    trace_term = torch.sum(var1 * inv_var2, dim=-1)
    quad_term = torch.sum(diff * diff * inv_var2, dim=-1)
    logdet_term = torch.sum(logvars2, dim=-1)[None, :] - torch.sum(logvars1, dim=-1)[:, None]
    return 0.5 * (trace_term + quad_term + logdet_term - mus1.shape[-1])
