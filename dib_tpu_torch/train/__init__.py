"""Training: the trainer, its losses, history and hooks."""

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
