"""Training: the trainer, its losses, history, hooks, checkpoints and
preemption."""

from dib_tpu_torch.train.checkpoint import (
    CheckpointCorruptionError,
    CheckpointHook,
    DIBCheckpointer,
)
from dib_tpu_torch.train.history import HistoryRecord, history_extend, history_init, history_record
from dib_tpu_torch.train.hooks import (
    CompressionMatrixHook,
    Every,
    InfoPerFeatureHook,
    all_features_bounds,
)
from dib_tpu_torch.train.loop import (
    DIBTrainer,
    GeneratorDraws,
    TrainConfig,
    TrainState,
    make_optimizer,
)
from dib_tpu_torch.train.preempt import PREEMPT_EXIT_CODE, PreemptionGuard, TrainingPreempted
