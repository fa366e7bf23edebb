"""Characterization of the MI sandwich bounds on synthetic channels
(counterpart of ``dib_tpu/workloads/characterization.py``).

Gaussian channels with KNOWN mutual information (uniform binary X in 1, 2,
4 or 6 dimensions, and continuous uniform X), swept over the separation
scale and the evaluation batch size {64, 256, 1024}: the InfoNCE/LOO
sandwich bounds against brute-force Monte Carlo ground truth, mean and std
over repeats, with residual plots.

Ground truth (host numpy, float64, the JAX package's code):
  - discrete X (uniform over {-1,+1}^k): the marginal p(u) is an EXACT
    2^k-component Gaussian mixture, so only u is Monte Carlo;
  - continuous X: the marginal is a large reference mixture.

The estimator under test is the port's production path,
:func:`~dib_tpu_torch.ops.info_bounds.mi_sandwich_from_params` on the
device (the ``mi_row_stats`` kernel on the GPU, float32 log space); the
noise of repeat r comes from a generator seeded with ``seed * 1000 + r``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.ops.entropy import LN2
from dib_tpu_torch.ops.info_bounds import mi_sandwich_from_params


@dataclass(frozen=True)
class SyntheticChannel:
    """U = scale * X (padded to ``embedding_dim``) + N(0, exp(logvar)).

    ``input_bits`` > 0: X uniform over the 2^k corners of {-1,+1}^k.
    ``input_bits`` == 0: continuous X ~ Uniform[-1, 1] (1-D).
    """

    input_bits: int = 1
    scale: float = 2.0
    logvar: float = 0.0
    embedding_dim: int = 8

    @property
    def is_discrete(self) -> bool:
        return self.input_bits > 0

    @property
    def input_dim(self) -> int:
        return self.input_bits if self.is_discrete else 1

    def sample_x(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.is_discrete:
            return (rng.integers(0, 2, size=(n, self.input_bits)) * 2 - 1).astype(
                np.float64
            )
        return rng.uniform(-1.0, 1.0, size=(n, 1))

    def mus(self, x: np.ndarray) -> np.ndarray:
        """[N, embedding_dim] channel means: scale * x, zero-padded."""
        pad = self.embedding_dim - x.shape[-1]
        return np.concatenate(
            [self.scale * x, np.zeros((x.shape[0], pad))], axis=-1
        )


def _log_gaussian_mixture(u: np.ndarray, centers: np.ndarray, logvar: float) -> np.ndarray:
    """log[(1/M) sum_m N(u; c_m, e^logvar I)] for [N, d] u and [M, d] centers,
    float64 log-space (logsumexp) on host."""
    d = u.shape[-1]
    # ||u - c||^2 via the norm expansion (never materializes [N, M, d]; the
    # [N, M] matrix itself is the peak allocation)
    sq = (
        (u**2).sum(-1)[:, None]
        + (centers**2).sum(-1)[None, :]
        - 2.0 * u @ centers.T
    )
    z2 = np.maximum(sq, 0.0) / np.exp(logvar)
    log_p = -0.5 * (z2 + d * logvar + d * np.log(2.0 * np.pi))     # [N, M]
    m = log_p.max(axis=1, keepdims=True)
    return (m[:, 0] + np.log(np.mean(np.exp(log_p - m), axis=1)))


def monte_carlo_mi_bits(
    channel: SyntheticChannel,
    num_samples: int = 20_000,
    num_marginal_centers: int = 4096,
    seed: int = 0,
) -> float:
    """Brute-force I(U; X) in bits: E_{x, u|x}[log p(u|x) - log p(u)].

    For discrete X the marginal mixture is exact (all 2^k centers); for
    continuous X it uses ``num_marginal_centers`` reference draws.
    """
    rng = np.random.default_rng(seed)
    d = channel.embedding_dim
    x = channel.sample_x(rng, num_samples)
    mus = channel.mus(x)
    u = mus + rng.normal(size=(num_samples, d)) * np.exp(channel.logvar / 2.0)

    # conditional log-density at the sampled (x, u) pairs
    z2 = ((u - mus) ** 2).sum(-1) / np.exp(channel.logvar)
    log_cond = -0.5 * (z2 + d * channel.logvar + d * np.log(2.0 * np.pi))

    if channel.is_discrete:
        corners = np.array(
            np.meshgrid(*[[-1.0, 1.0]] * channel.input_bits)
        ).reshape(channel.input_bits, -1).T                         # [2^k, k]
        centers = channel.mus(corners)
    else:
        centers = channel.mus(channel.sample_x(rng, num_marginal_centers))
    log_marg = _log_gaussian_mixture(u, centers, channel.logvar)
    return float(np.mean(log_cond - log_marg) / LN2)


@dataclass
class CharacterizationResult:
    """One (channel, batch_size) cell of the sweep, all values in bits."""

    channel: SyntheticChannel
    batch_size: int
    mc_truth: float
    lower_mean: float
    lower_std: float
    upper_mean: float
    upper_std: float

    @property
    def lower_residual(self) -> float:
        return self.lower_mean - self.mc_truth

    @property
    def upper_residual(self) -> float:
        return self.upper_mean - self.mc_truth


def estimate_bounds_bits(channel: SyntheticChannel, batch_size: int, num_repeats: int = 8,
                         seed: int = 0, *, device=None) -> tuple[np.ndarray, np.ndarray]:
    """([R] lower, [R] upper) sandwich bounds in bits over independent
    batches, through the production float32 estimator on ``device``
    (``None`` means the GPU); repeat r's noise from a generator on the
    device seeded with ``seed * 1000 + r``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    bounds = []
    for r in range(num_repeats):
        x = channel.sample_x(rng, batch_size)
        mus = torch.as_tensor(channel.mus(x), dtype=torch.float32, device=device)
        logvars = torch.full(mus.shape, channel.logvar, dtype=torch.float32, device=device)
        generator = torch.Generator(device=device).manual_seed(seed * 1000 + r)
        bounds.append(torch.stack(mi_sandwich_from_params(mus, logvars, generator)))
    lowers, uppers = torch.stack(bounds).cpu().double().numpy().T
    return lowers / LN2, uppers / LN2


def run_characterization(
    input_bits_list: Sequence[int] = (1, 2, 4, 6, 0),
    scales: Sequence[float] | None = None,
    batch_sizes: Sequence[int] = (64, 256, 1024),
    logvar: float = 0.0,
    embedding_dim: int = 8,
    num_repeats: int = 8,
    mc_samples: int = 20_000,
    seed: int = 0,
    *,
    device=None,
) -> list[CharacterizationResult]:
    """The full characterization sweep: one result per (channel dims,
    scale, batch size) cell; ``input_bits_list`` holds 0 for the continuous
    channel. The bounds run on ``device`` (``None`` means the GPU)."""
    if scales is None:
        scales = np.logspace(-1, 1, 7)
    results = []
    for bits in input_bits_list:
        for scale in scales:
            channel = SyntheticChannel(
                input_bits=bits, scale=float(scale),
                logvar=logvar, embedding_dim=embedding_dim,
            )
            truth = monte_carlo_mi_bits(channel, num_samples=mc_samples, seed=seed)
            for batch_size in batch_sizes:
                lowers, uppers = estimate_bounds_bits(channel, batch_size, num_repeats, seed,
                                                      device=device)
                results.append(CharacterizationResult(
                    channel=channel,
                    batch_size=batch_size,
                    mc_truth=truth,
                    lower_mean=float(lowers.mean()),
                    lower_std=float(lowers.std()),
                    upper_mean=float(uppers.mean()),
                    upper_std=float(uppers.std()),
                ))
    return results


def save_characterization_plots(results: list[CharacterizationResult], outdir: str) -> list[str]:
    """Bounds-vs-truth curves and residual panels, one figure per channel
    dimensionality (needs matplotlib)."""
    from dib_tpu_torch.viz import pyplot

    plt = pyplot("save_characterization_plots")
    os.makedirs(outdir, exist_ok=True)
    paths = []
    by_bits: dict[int, list[CharacterizationResult]] = {}
    for r in results:
        by_bits.setdefault(r.channel.input_bits, []).append(r)

    for bits, rows in by_bits.items():
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))
        batch_sizes = sorted({r.batch_size for r in rows})
        for bs in batch_sizes:
            sub = sorted((r for r in rows if r.batch_size == bs),
                         key=lambda r: r.channel.scale)
            scales = [r.channel.scale for r in sub]
            ax1.errorbar(scales, [r.lower_mean for r in sub],
                         yerr=[r.lower_std for r in sub], marker="o",
                         label=f"lower, B={bs}")
            ax1.errorbar(scales, [r.upper_mean for r in sub],
                         yerr=[r.upper_std for r in sub], marker="s",
                         linestyle="--", label=f"upper, B={bs}")
            ax2.plot(scales, [r.lower_residual for r in sub], marker="o",
                     label=f"lower, B={bs}")
            ax2.plot(scales, [r.upper_residual for r in sub], marker="s",
                     linestyle="--", label=f"upper, B={bs}")
        truth = sorted({(r.channel.scale, r.mc_truth) for r in rows})
        ax1.plot([t[0] for t in truth], [t[1] for t in truth], "k:", lw=2,
                 label="MC truth")
        name = f"{bits}-bit X" if bits else "continuous X"
        ax1.set(xscale="log", xlabel="separation scale", ylabel="I(U;X) (bits)",
                title=f"Sandwich bounds, {name}")
        ax2.set(xscale="log", xlabel="separation scale",
                ylabel="bound - truth (bits)", title="Residuals")
        ax2.axhline(0.0, color="k", lw=0.5)
        ax1.legend(fontsize=7)
        path = os.path.join(outdir, f"characterization_{bits}bit.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths
