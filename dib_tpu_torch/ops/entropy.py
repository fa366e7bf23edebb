"""Entropy helpers and exact truth-table information (counterpart of the
host-side parts of ``dib_tpu/ops/entropy.py``): Shannon entropy in bits of a
probability vector or a symbol sequence, and the exact empirical mutual
information the boolean workload's oracles are built on. Nats convert to
bits at the reporting boundary with :func:`nats_to_bits`.
"""

from __future__ import annotations

import numpy as np

LN2 = float(np.log(2.0))


def nats_to_bits(x):
    """Convert nats to bits at the reporting boundary."""
    return np.asarray(x) / LN2


def entropy_bits(probabilities) -> float:
    """Shannon entropy (bits) of a probability vector; zero entries contribute 0."""
    p = np.asarray(probabilities, dtype=np.float64)
    return float(-np.sum(p * np.log2(np.where(p > 0, p, 1.0))))


def _rows_to_codes(vals: np.ndarray) -> np.ndarray:
    """Map rows of a small integer array to unique integer codes."""
    vals = np.asarray(vals)
    if vals.ndim == 1:
        return vals
    _, codes = np.unique(vals, axis=0, return_inverse=True)
    return codes


def sequence_entropy_bits(seq) -> float:
    """Empirical entropy (bits) of a symbol sequence (rows hashed if 2-D)."""
    codes = _rows_to_codes(np.asarray(seq))
    _, counts = np.unique(codes, return_counts=True)
    return entropy_bits(counts / counts.sum())


def joint_entropy_bits(vals1, vals2) -> float:
    """Empirical joint entropy (bits) of two aligned symbol sequences."""
    c1 = _rows_to_codes(np.asarray(vals1))
    c2 = _rows_to_codes(np.asarray(vals2))
    return sequence_entropy_bits(np.stack([c1, c2], axis=-1))


def mutual_information_bits(vals1, vals2) -> float:
    """Exact empirical mutual information (bits): H(A) + H(B) - H(A,B); on
    a full truth table, the exact MI oracle of the boolean workload."""
    return (sequence_entropy_bits(vals1) + sequence_entropy_bits(vals2)
            - joint_entropy_bits(vals1, vals2))
