"""Bottleneck-strength (beta) schedules and the learning-rate warmup
(counterpart of ``dib_tpu/ops/schedules.py``).

Beta is computed from the epoch index, never stored in the model. Values are
float32, computed as the JAX package computes them: the log-span of static
endpoints is taken on the host in float64 and only the exp rounds in float32.
"""

from __future__ import annotations

import math

import torch


def log_annealed_beta(step, beta_start: float, beta_end: float,
                      num_annealing_steps: int, num_pretraining_steps: int = 0,
                      clip_progress: bool = True) -> torch.Tensor:
    """Log-linear beta ramp with an optional flat pretraining phase.

    beta(t) = beta_start * exp(p(t) * (log beta_end - log beta_start)),
    p(t) = (t - pre) / anneal, clamped to [0, 1] when ``clip_progress``
    (else only below). ``step`` may be an int or a tensor of steps; the
    result is a float32 tensor on the CPU of the same shape.
    """
    step = torch.as_tensor(step, dtype=torch.float32)
    progress = (step - num_pretraining_steps) / torch.tensor(
        float(max(num_annealing_steps, 1)), dtype=torch.float32)
    progress = progress.clamp(0.0, 1.0) if clip_progress else progress.clamp_min(0.0)
    delta = torch.tensor(math.log(beta_end) - math.log(beta_start), dtype=torch.float32)
    return torch.tensor(beta_start, dtype=torch.float32) * torch.exp(progress * delta)


def beta_schedule(beta_start: float, beta_end: float, num_annealing_steps: int,
                  num_pretraining_steps: int = 0):
    """``schedule(step) -> beta`` as a closure over the endpoints."""

    def schedule(step):
        return log_annealed_beta(step, beta_start, beta_end, num_annealing_steps,
                                 num_pretraining_steps)

    return schedule


def beta_grid(beta_start: float, beta_end: float, num: int) -> torch.Tensor:
    """Logarithmically spaced float32 grid of beta values (the sweep axis)."""
    return torch.logspace(math.log10(beta_start), math.log10(beta_end), num,
                          dtype=torch.float32)


def linear_warmup(step, base_value: float, num_warmup_steps: int) -> torch.Tensor:
    """Linear 0 -> base ramp over ``num_warmup_steps``, then constant."""
    step = torch.as_tensor(step, dtype=torch.float32)
    return torch.clamp(step / float(max(num_warmup_steps, 1)), max=1.0) * base_value
