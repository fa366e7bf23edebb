"""Dataset registry and the dataset-bundle contract.

Counterpart of ``dib_tpu/data/registry.py``: bundles are plain numpy, so the
same data feeds both packages.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, Sequence

import numpy as np


@dataclass
class DatasetBundle:
    """Everything a workload needs to train or query a Distributed IB model."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_valid: np.ndarray
    y_valid: np.ndarray
    feature_dimensionalities: Sequence[int]
    output_dimensionality: int
    loss: str                       # 'bce' | 'sparse_ce' | 'mse' | 'infonce'
    loss_is_info_based: bool
    output_activation: str | None = None
    metrics: Sequence[str] = field(default_factory=tuple)
    feature_labels: Sequence[str] | None = None
    x_valid_raw: np.ndarray | None = None
    extras: dict = field(default_factory=dict)  # workload-specific payloads

    @property
    def number_features(self) -> int:
        return len(self.feature_dimensionalities)

    def __post_init__(self):
        if self.feature_labels is None:
            self.feature_labels = [f"Feature {i}" for i in range(self.number_features)]
        total = int(np.sum(self.feature_dimensionalities))
        if self.x_train.shape[-1] != total:
            raise ValueError(
                f"x_train width {self.x_train.shape[-1]} != sum(feature dims) {total}")

    def as_vanilla_ib(self) -> "DatasetBundle":
        """Every feature into one bottleneck (the CLI's ``--ib``): a copy
        with a single feature as wide as all of them."""
        out = copy.copy(self)
        out.feature_dimensionalities = [int(np.sum(self.feature_dimensionalities))]
        out.feature_labels = ["All features"]
        return out


_REGISTRY: Dict[str, Callable[..., DatasetBundle]] = {}
# datasets whose bundles need a loss of their own, known before fetching
_LOSSES: Dict[str, str] = {}


def register_dataset(name: str, loss: str | None = None):
    """Decorator: register a fetch function under ``name``. ``loss`` names
    the loss its bundles carry where the model must be built for it
    (``'infonce'`` needs a y encoder), so a caller can check before
    fetching."""

    def deco(fn):
        _REGISTRY[name] = fn
        if loss is not None:
            _LOSSES[name] = loss
        return fn

    return deco


def dataset_loss(name: str) -> str | None:
    """The loss declared with ``register_dataset`` for ``name``, if any."""
    import dib_tpu_torch.data  # noqa: F401  (registers every dataset)

    return _LOSSES.get(name)


def get_dataset(name: str, **kwargs) -> DatasetBundle:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown dataset {name!r}. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_datasets() -> list[str]:
    """Every registered dataset (the package's modules registered)."""
    import dib_tpu_torch.data  # noqa: F401  (registers every dataset)

    return sorted(_REGISTRY)
