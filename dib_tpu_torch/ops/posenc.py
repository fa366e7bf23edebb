"""Sinusoidal positional encoding for low-dimensional features
(counterpart of ``dib_tpu/ops/posenc.py``)."""

from __future__ import annotations

import numpy as np
import torch


def positional_encoding_frequencies(num_frequencies: int, start_power: int = 1) -> np.ndarray:
    """Frequency ladder ``2^start_power .. 2^(start_power + num - 1)``."""
    if num_frequencies <= 0:
        return np.zeros((0,), dtype=np.float32)
    return (2.0 ** np.arange(start_power, start_power + num_frequencies)).astype(np.float32)


def positional_encoding(x: torch.Tensor, frequencies) -> torch.Tensor:
    """``[x, sin(f_1 x) over all dims, sin(f_2 x) over all dims, ...]``.

    Frequency-major, as the JAX package lays it out, so first-layer weights
    carry over unchanged. Padding-safe: sin(0) = 0 keeps zero-padded feature
    dimensions zero.
    """
    frequencies = torch.as_tensor(frequencies, dtype=x.dtype, device=x.device)
    if frequencies.numel() == 0:
        return x
    sines = torch.sin(x[..., None] * frequencies)                # [..., d, k]
    sines = sines.transpose(-1, -2).reshape(*x.shape[:-1], -1)   # [..., k*d]
    return torch.cat([x, sines], dim=-1)


def posenc_output_dim(input_dim: int, num_frequencies: int) -> int:
    """Output width of ``positional_encoding`` for an ``input_dim``-wide input."""
    return input_dim * (1 + max(num_frequencies, 0))
