"""The amorphous-plasticity set-transformer workload: its configuration and
model (counterpart of the configuration part of
``dib_tpu/workloads/amorphous.py``).

Per-particle DIB (one shared Gaussian encoder, KL summed over latent dims
and particles) + set-transformer aggregator; 25k steps of batch 32
neighborhoods x 50 particles, a per-step beta log-ramp 2e-6 -> 2e-1, a
linear LR warmup, and per-particle MI sandwich bounds every ``eval_every``
steps. ``run_amorphous_workload`` with its probe-grid information maps
and plots is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dib_tpu_torch.models.per_particle import PerParticleDIBModel
from dib_tpu_torch.train.loop import TrainConfig


@dataclass(frozen=True)
class AmorphousWorkloadConfig:
    """The flagship's defaults (the JAX package's ``AmorphousWorkloadConfig``
    without the probe-map settings, which come with the probe maps)."""

    learning_rate: float = 1e-4
    batch_size: int = 32
    num_steps: int = 25_000
    beta_start: float = 2e-6
    beta_end: float = 2e-1
    warmup_steps: int = 500
    eval_every: int = 250             # MI bounds cadence, in steps
    number_particles: int = 50
    mi_eval_batch_size: int = 1024
    mi_eval_batches: int = 4

    def train_config(self, steps_per_epoch: int = 1) -> TrainConfig:
        """As a TrainConfig with epoch == ``steps_per_epoch`` train steps
        (with 1, beta advances per step, the reference schedule)."""
        return TrainConfig(
            learning_rate=self.learning_rate,
            batch_size=self.batch_size,
            beta_start=self.beta_start,
            beta_end=self.beta_end,
            num_pretraining_epochs=0,
            num_annealing_epochs=self.num_steps // steps_per_epoch,
            steps_per_epoch=steps_per_epoch,
            warmup_steps=self.warmup_steps,
            max_val_points=1024,
        )


def build_model(config: AmorphousWorkloadConfig, *, device=None,
                generator: torch.Generator | None = None, **overrides) -> PerParticleDIBModel:
    """The full architecture; ``overrides`` (e.g. ``use_flash``) set model
    fields, or shrink it for tests."""
    return PerParticleDIBModel(num_particles=config.number_particles, device=device,
                               generator=generator, **overrides)
