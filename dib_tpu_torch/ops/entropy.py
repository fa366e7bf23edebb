"""Entropy helpers for the boolean-circuit bundle (counterpart of the parts of
``dib_tpu/ops/entropy.py`` the port uses so far)."""

from __future__ import annotations

import numpy as np


def entropy_bits(probabilities) -> float:
    """Shannon entropy (bits) of a probability vector; zero entries contribute 0."""
    p = np.asarray(probabilities, dtype=np.float64)
    return float(-np.sum(p * np.log2(np.where(p > 0, p, 1.0))))


def sequence_entropy_bits(seq) -> float:
    """Empirical entropy (bits) of a symbol sequence (rows hashed if 2-D)."""
    vals = np.asarray(seq)
    codes = vals if vals.ndim == 1 else np.unique(vals, axis=0, return_inverse=True)[1]
    _, counts = np.unique(codes, return_counts=True)
    return entropy_bits(counts / counts.sum())
