"""Parallel training: the beta sweep, R replicas as one stacked program."""

from dib_tpu_torch.parallel.sweep import (
    BetaSweepTrainer,
    PerReplicaHook,
    StackedDraws,
    member_seed,
    sweep_records,
)
from dib_tpu_torch.parallel.sweep_hooks import SweepCompressionHook, SweepInfoPerFeatureHook
