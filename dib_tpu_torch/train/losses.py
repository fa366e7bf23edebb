"""Task losses and metrics, resolved by name from the dataset bundle
(counterpart of ``dib_tpu/train/losses.py``). Losses are batch means in nats;
'infonce' is handled by the trainer's contrastive branch."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _flat(logits: torch.Tensor, labels: torch.Tensor):
    return (logits.reshape(labels.shape[0], -1).squeeze(-1),
            labels.reshape(labels.shape[0], -1).squeeze(-1))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy; logits [B, 1] or [B], labels in {0, 1}."""
    logits, labels = _flat(logits, labels)
    return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))


def sparse_ce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean categorical cross entropy; logits [B, C], integer labels [B]."""
    return F.cross_entropy(logits, labels.reshape(-1).long())


def mse(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean((predictions - targets.reshape(predictions.shape)).square())


LOSSES = {
    "bce": bce_with_logits,
    "sparse_ce": sparse_ce_with_logits,
    "mse": mse,
}


def resolve_loss(name: str):
    if name not in LOSSES:
        raise ValueError(f"Unknown loss {name!r} (infonce is handled by the contrastive step)")
    return LOSSES[name]


def binary_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits, labels = _flat(logits, labels)
    return ((logits > 0).float() == labels).float().mean()


def multiclass_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels.reshape(-1)).float().mean()


def accuracy_for(loss_name: str):
    return binary_accuracy if loss_name == "bce" else multiclass_accuracy
