"""β-aware boundary anomaly detection, the finite half of the divergence
guard (counterpart of ``dib_tpu/train/anomaly.py``, numpy only).

Channels are what the fit already fetches at each chunk boundary
(``loss``, ``val_loss``, each feature's ``kl/<i>``) plus ``param_norm``,
the parameters' global L2 norm. Each boundary's first difference is scored
against the trailing window's median and MAD with relative and absolute
floors; windows reset at the pretraining-to-annealing boundary, annealing
gets a wider threshold, and the loss and KL channels are scored one-sided
(only a move to worse can be a fault: a KL collapse is a transition).
Non-finite values always fire. A finding rolls the fit back like a NaN
does (``DIBTrainer.fit``) or quarantines a sweep member
(``BetaSweepTrainer.fit``). The detector consumes host floats only.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

__all__ = ["AnomalyFinding", "BoundaryAnomalyDetector",
           "boundary_channels"]

#: Channels scored two-sided (any direction is suspect). Everything else
#: is one-sided: only movement toward "worse" (larger) can be anomalous,
#: so the annealing schedule's natural compression never false-positives.
_TWO_SIDED = ("param_norm",)


@dataclass(frozen=True)
class AnomalyFinding:
    """One channel's anomaly verdict at one chunk boundary."""

    channel: str
    kind: str              # "nonfinite" | "spike"
    value: float
    zscore: float | None   # None for non-finite values
    threshold: float | None
    phase: str             # "pretrain" | "anneal"


def boundary_channels(row: dict, param_norm: float | None = None) -> dict:
    """The detector's channel dict from a fetched boundary row
    (``loss`` / ``val_loss`` / ``kl_per_feature``), plus the optional
    global parameter norm."""
    channels = {
        "loss": float(np.asarray(row["loss"]).ravel()[0]),
        "val_loss": float(np.asarray(row["val_loss"]).ravel()[0]),
    }
    for i, kl in enumerate(np.asarray(row["kl_per_feature"]).ravel()):
        channels[f"kl/{i}"] = float(kl)
    if param_norm is not None:
        channels["param_norm"] = float(param_norm)
    return channels


class BoundaryAnomalyDetector:
    """Per-run (or per-sweep-member) robust anomaly detector.

    ``observe`` consumes one boundary's channels and returns the list of
    :class:`AnomalyFinding` (empty = clean). Clean values join the
    trailing window; anomalous values never do, so the yardstick stays
    uncontaminated for the post-rollback replay. ``rewind`` drops
    observations past a restored epoch after a rollback, keeping the
    replayed boundaries' re-observations deterministic.

    Thresholds are deliberately loose — the detector exists for
    order-of-magnitude SDC, not for statistics on healthy noise: a spike
    must clear ``z_threshold`` (×``anneal_factor`` during annealing)
    robust MADs *and* the relative floor (``rel_floor`` of the metric's
    level) before anything fires, and nothing fires until ``min_points``
    clean deltas exist in the current phase. ``abs_floor`` is an
    ABSOLUTE slack in the metric's units (nats / loss scale): a
    compressed-away KL channel sits at ~1e-8, where MAD and the relative
    floor both vanish — without the absolute floor a benign 1e-4-nats
    flutter would z-spike and roll a healthy run back (the deployer's
    canary carries the same idea as ``KL_SLACK_NATS``). Real SDC moves
    these metrics by whole nats, thousands of floors away.
    """

    def __init__(self, num_pretraining_epochs: int, *, window: int = 8,
                 min_points: int = 4, z_threshold: float = 16.0,
                 anneal_factor: float = 2.0, rel_floor: float = 0.02,
                 abs_floor: float = 1e-3):
        if window < min_points + 1:
            raise ValueError(
                f"window ({window}) must hold at least min_points + 1 "
                f"({min_points + 1}) boundary values")
        self.num_pretraining_epochs = int(num_pretraining_epochs)
        self.window = int(window)
        self.min_points = int(min_points)
        self.z_threshold = float(z_threshold)
        self.anneal_factor = float(anneal_factor)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        # channel -> deque[(epoch, value)] of CLEAN observations, reset
        # at each β-phase boundary
        self._series: dict[str, deque] = {}
        self._series_phase: dict[str, str] = {}

    @classmethod
    def for_config(cls, config, **overrides) -> "BoundaryAnomalyDetector":
        """A detector conditioned on a ``TrainConfig``'s β schedule."""
        return cls(config.num_pretraining_epochs, **overrides)

    def phase(self, epoch: int) -> str:
        """The β-annealing phase an epoch's boundary belongs to."""
        return "pretrain" if epoch <= self.num_pretraining_epochs \
            else "anneal"

    # ------------------------------------------------------------ scoring
    def _judge(self, channel: str, epoch: int, value: float,
               phase: str) -> AnomalyFinding | None:
        if not np.isfinite(value):
            return AnomalyFinding(channel=channel, kind="nonfinite",
                                  value=float(value), zscore=None,
                                  threshold=None, phase=phase)
        series = self._series.get(channel)
        if series is None or self._series_phase.get(channel) != phase:
            return None            # fresh phase/channel: observe only
        values = [v for _, v in series]
        deltas = np.diff(np.asarray(values, np.float64))
        if deltas.size < self.min_points:
            return None
        d = float(value - values[-1])
        med = float(np.median(deltas))
        mad = float(np.median(np.abs(deltas - med)))
        level = max(abs(float(np.median(values))), abs(values[-1]))
        scale = max(1.4826 * mad, self.rel_floor * level, self.abs_floor)
        if channel not in _TWO_SIDED and d <= med:
            return None            # one-sided: improving is never a fault
        z = abs(d - med) / scale
        threshold = self.z_threshold * (
            self.anneal_factor if phase == "anneal" else 1.0)
        if z <= threshold:
            return None
        return AnomalyFinding(channel=channel, kind="spike",
                              value=float(value), zscore=round(z, 2),
                              threshold=threshold, phase=phase)

    def observe(self, epoch: int, channels: dict[str, float],
                record: bool = True) -> list[AnomalyFinding]:
        """Judge one boundary; clean values join the window when
        ``record`` (peek mode, ``record=False``, is the sweep's
        healed-row recheck — judging a replayed value without committing
        it twice)."""
        phase = self.phase(epoch)
        findings: list[AnomalyFinding] = []
        for channel, value in channels.items():
            value = float(value)
            finding = self._judge(channel, epoch, value, phase)
            if finding is not None:
                findings.append(finding)
                continue
            if not record:
                continue
            series = self._series.get(channel)
            if series is None or self._series_phase.get(channel) != phase:
                series = deque(maxlen=self.window)
                self._series[channel] = series
                self._series_phase[channel] = phase
            series.append((int(epoch), value))
        return findings

    def rewind(self, epoch: int) -> None:
        """Drop observations PAST ``epoch`` (a rollback restored that
        boundary; the replay will re-observe the later ones)."""
        for channel, series in self._series.items():
            kept = [(e, v) for e, v in series if e <= epoch]
            series.clear()
            series.extend(kept)
