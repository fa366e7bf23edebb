"""Training history (counterpart of ``dib_tpu/train/history.py``).

A preallocated dict of float32 tensors on the trainer's device, one row per
recorded epoch, written at a host-side integer cursor, so recording a row
needs no device sync; it is fetched once, as a :class:`HistoryRecord`. A
sweep's history puts a replica axis first ([R, T, ...]) under one cursor.
Everything is recorded in nats and converted to bits by
:meth:`HistoryRecord.to_bits` at the reporting boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

FIELDS = ("beta", "kl_per_feature", "loss", "val_loss", "metric", "val_metric")


def history_init(num_records: int, num_features: int, device=None,
                 replicas: int | None = None) -> dict:
    """Preallocated history: one row per recorded epoch (of each replica)."""
    lead = () if replicas is None else (replicas,)
    history = {name: torch.zeros(lead + (num_records,), device=device) for name in FIELDS}
    history["kl_per_feature"] = torch.zeros(lead + (num_records, num_features), device=device)
    history["cursor"] = 0
    return history


def _time_axis(history: dict) -> int:
    """0 for a serial history, 1 for a sweep's [R, T, ...]."""
    return history["beta"].dim() - 1


def history_extend(history: dict, extra_records: int) -> dict:
    """A new history with ``extra_records`` more rows of capacity (zeros past
    the end); the cursor and the recorded rows are kept."""
    if extra_records < 0:
        raise ValueError(f"extra_records must be >= 0, got {extra_records}")
    out = {"cursor": history["cursor"]}
    axis = _time_axis(history)
    for name in FIELDS:
        buf = history[name]
        pad = buf.new_zeros((*buf.shape[:axis], extra_records, *buf.shape[axis + 1:]))
        out[name] = torch.cat([buf, pad], dim=axis)
    return out


def history_record(history: dict, row: dict) -> dict:
    """Write one row at the cursor (in place) and advance the cursor; a
    sweep's row holds every replica's value on a leading axis."""
    cursor = history["cursor"]
    at = (slice(None),) * _time_axis(history) + (cursor,)
    with torch.no_grad():
        for name, value in row.items():
            history[name][at] = value
    history["cursor"] = cursor + 1
    return history


@dataclass
class HistoryRecord:
    """Host-side view of a fetched history (trimmed to the cursor)."""

    beta: np.ndarray
    kl_per_feature: np.ndarray       # [T, F] nats
    loss: np.ndarray                 # [T] nats (task loss only, beta*KL removed)
    val_loss: np.ndarray
    metric: np.ndarray
    val_metric: np.ndarray
    # set by sweep_records for a member the sweep's quarantine ejected: its
    # trajectory after the ejection epoch is garbage
    ejected: bool = False

    @classmethod
    def from_device(cls, history: dict) -> "HistoryRecord":
        n = history["cursor"]
        return cls(**{name: history[name][:n].detach().cpu().numpy() for name in FIELDS})

    def to_bits(self, loss_is_info_based: bool = True) -> "HistoryRecord":
        """Nats -> bits for KL always; for losses only when info-based."""
        ln2 = np.log(2.0)
        scale = ln2 if loss_is_info_based else 1.0
        return HistoryRecord(
            beta=self.beta,
            kl_per_feature=self.kl_per_feature / ln2,
            loss=self.loss / scale,
            val_loss=self.val_loss / scale,
            metric=self.metric,
            val_metric=self.val_metric,
            ejected=self.ejected,
        )

    @property
    def total_kl(self) -> np.ndarray:
        return self.kl_per_feature.sum(-1)

    @property
    def combined_loss(self) -> np.ndarray:
        """The reported objective: task + beta * total KL."""
        return self.loss + self.beta * self.total_kl
