"""Mutual-information sandwich bounds (InfoNCE lower / leave-one-out upper),
in log space throughout (counterpart of ``dib_tpu/ops/info_bounds.py``).

    log p(u_i|x_j) = -1/2 sum_d (u_i - mu_j)^2 / var_j - 1/2 sum_d logvar_j - d/2 log(2 pi)

    InfoNCE lower = mean_i [ log p_ii - (logsumexp_j      log p_ij - log B) ]
    LOO upper     = mean_i [ log p_ii - (logsumexp_{j != i} log p_ij - log B) ]

The LOO denominator divides by B, not B - 1: the diagonal is excluded from
the logsumexp but the mean still runs over all B entries, as in the
reference semantics the JAX package reproduces. Every bound goes through
:func:`dib_tpu_torch.ops.density.mi_row_stats` (the CUDA kernel on the GPU),
so the [B, B] matrix is never formed on the GPU.
"""

from __future__ import annotations

import math

import torch

from dib_tpu_torch.ops.density import NEG_INF, mi_row_stats
from dib_tpu_torch.ops.gaussian import _LOG_2PI, gaussian_log_density_mat, reparameterize


def sandwich_from_row_stats(log_p_ii: torch.Tensor, lse_full: torch.Tensor,
                            lse_off: torch.Tensor):
    """(InfoNCE lower, LOO upper) from the per-row statistics of a B-row
    batch, averaged over the last axis (one value per leading group)."""
    log_batch = math.log(log_p_ii.shape[-1])
    lower = torch.mean(log_p_ii - (lse_full - log_batch), dim=-1)
    upper = torch.mean(log_p_ii - (lse_off - log_batch), dim=-1)
    return lower, upper


def mi_row_stats_blocked(u: torch.Tensor, mus: torch.Tensor, logvars: torch.Tensor,
                         row_block: int | None = None):
    """Per-row ``(diag, lse_full, lse_off)`` of the square [B, B] log-density
    matrix in plain PyTorch, ``row_block`` rows of the matrix at a time.

    Only the three per-row reductions of each block are kept, so peak memory
    is [row_block, B, d] instead of [B, B, d]; the last block may be ragged.
    Without ``row_block`` the whole matrix is formed and reduced. It never
    routes to a kernel (the kernel microbench times it against them).
    Counterpart of ``dib_tpu/ops/info_bounds.py::_mi_row_stats_xla``.
    """
    n = u.shape[0]
    block = n if row_block is None else row_block
    if block < 1:
        raise ValueError(f"row_block must be positive, got {row_block}")
    cols = torch.arange(mus.shape[0], device=u.device)
    diags, fulls, offs = [], [], []
    for r0 in range(0, n, block):
        log_p = gaussian_log_density_mat(u[r0:r0 + block], mus, logvars)     # [rb, B]
        rows = torch.arange(r0, r0 + log_p.shape[0], device=u.device)
        is_diag = rows[:, None] == cols[None, :]
        diags.append(torch.sum(torch.where(is_diag, log_p, 0.0), dim=1))
        fulls.append(torch.logsumexp(log_p, dim=1))
        offs.append(torch.logsumexp(log_p.masked_fill(is_diag, NEG_INF), dim=1))
    return torch.cat(diags), torch.cat(fulls), torch.cat(offs)


def mi_sandwich_from_params(mus: torch.Tensor, logvars: torch.Tensor,
                            generator: torch.Generator | None = None,
                            u: torch.Tensor | None = None):
    """Sandwich bounds for one batch, from Gaussian channel parameters.

    ``mus``/``logvars`` are [B, d], or [G, B, d] for G channels at once (one
    kernel launch). ``u`` is an optional pre-drawn sample of the same shape;
    otherwise it is drawn from ``generator``. Returns (lower, upper) in nats,
    scalars or [G].
    """
    if u is None:
        u = reparameterize(mus, logvars, generator)
    return sandwich_from_row_stats(
        *mi_row_stats(u.contiguous(), mus.contiguous(), logvars.contiguous()))


def mi_sandwich_bounds(encode_fn, data: torch.Tensor,
                       generator: torch.Generator | None = None,
                       evaluation_batch_size: int = 1024,
                       number_evaluation_batches: int = 8,
                       u: torch.Tensor | None = None,
                       idx: torch.Tensor | None = None):
    """Average the sandwich bounds over several re-drawn evaluation batches.

    ``encode_fn`` maps a [B, ...] batch of ``data`` to ([B, d] mus, [B, d]
    logvars). Batches are drawn with replacement. ``idx``
    ([batches, B] row indices) and ``u`` ([batches, B, d] samples) replace
    the draws from ``generator``. Returns (lower, upper) in nats.
    """
    lowers, uppers = [], []
    for b in range(number_evaluation_batches):
        rows = idx[b] if idx is not None else torch.randint(
            0, data.shape[0], (evaluation_batch_size,), generator=generator,
            device=data.device)
        mus, logvars = encode_fn(data[rows])
        lower, upper = mi_sandwich_from_params(
            mus, logvars, generator, u=None if u is None else u[b])
        lowers.append(lower)
        uppers.append(upper)
    return torch.stack(lowers).mean(0), torch.stack(uppers).mean(0)


def mi_sandwich_probe(probe_mus: torch.Tensor, probe_logvars: torch.Tensor,
                      data_mus: torch.Tensor, data_logvars: torch.Tensor,
                      generator: torch.Generator | None = None,
                      u: torch.Tensor | None = None):
    """Per-probe sandwich bounds against a bank of data Gaussians.

    ``probe_*`` are [M, d] channel parameters at probe inputs, ``data_*``
    [N, d] at real data. ``u`` is an optional pre-drawn [M, d] sample.
    Returns ([M] lower, [M] upper) in nats. The InfoNCE denominator is the
    mean over N + 1 densities (the probe's own conditional folded in with
    logaddexp); the LOO denominator the mean over the N data conditionals.
    """
    n = data_mus.shape[0]
    if u is None:
        u = reparameterize(probe_mus, probe_logvars, generator)
    d = probe_mus.shape[-1]
    diff = (u - probe_mus) * torch.exp(-0.5 * probe_logvars)
    log_p_ii = -0.5 * (torch.sum(diff * diff, dim=-1)
                       + torch.sum(probe_logvars, dim=-1) + d * _LOG_2PI)   # [M]
    _, lse_data, _ = mi_row_stats(u.contiguous(), data_mus.contiguous(),
                                  data_logvars.contiguous(), diagonal=False)
    lse_with_self = torch.logaddexp(log_p_ii, lse_data)
    lower = log_p_ii - (lse_with_self - math.log(n + 1))
    upper = log_p_ii - (lse_data - math.log(n))
    return lower, upper
