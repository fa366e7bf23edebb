"""Probabilistic feature encoders (counterpart of ``dib_tpu/models/encoders.py``).

``FeatureEncoderBank`` runs all F per-feature Gaussian encoders as ONE stack
of batched matmuls over stacked ``[F, in, out]`` weights, with no Python loop
over features. Ragged features are zero-padded to a common width, which is
exact: sin(0) = 0 keeps the positional encoding zero on padding, and
first-layer weights that multiply zeros contribute nothing.

``compute_dtype`` (e.g. 'bfloat16') runs the encoders' hidden layers in that
type; their final layer is float32 on the hidden state, so the channel
parameters (mus, logvars) that KL, sampling and the MI bounds read are
float32 whatever the compute type.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dib_tpu_torch.models.mlp import MLP, Generators
from dib_tpu_torch.ops.posenc import (
    positional_encoding,
    positional_encoding_frequencies,
    posenc_output_dim,
)


def pad_and_stack_features(x: torch.Tensor, feature_dimensionalities: Sequence[int]) -> torch.Tensor:
    """Split [B, sum(dims)] into per-feature blocks, zero-pad to the max width,
    and stack to [F, B, max_dim] (feature-major)."""
    dims = list(feature_dimensionalities)
    max_dim = max(dims)
    if min(dims) == max_dim:   # equal widths: a view, no copies
        return x.unflatten(-1, (len(dims), max_dim)).movedim(-2, 0)
    blocks = torch.split(x, dims, dim=-1)
    return torch.stack([F.pad(b, (0, max_dim - d)) for b, d in zip(blocks, dims)], dim=0)


class GaussianEncoder(nn.Module):
    """Positional encoding + MLP -> (mu, logvar) for one feature, or for
    every particle of a set through one shared encoder (the particle axis is
    just another batch axis of the MLP).

    ``in_dim`` is the raw feature width; ``logvar_offset`` shifts the
    predicted log-variances after the split. With ``replicas=R``, R
    independent encoders over a leading replica axis of the input.
    """

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128, 128),
                 embedding_dim: int = 32, num_posenc_frequencies: int = 4,
                 posenc_start_power: int = 1,
                 activation: str | Callable | None = "relu", logvar_offset: float = 0.0,
                 generator: Generators = None, replicas: int | None = None,
                 compute_dtype=None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.logvar_offset = float(logvar_offset)
        self.register_buffer(
            "frequencies",
            torch.from_numpy(positional_encoding_frequencies(num_posenc_frequencies,
                                                             posenc_start_power)),
            persistent=False)
        self.mlp = MLP(posenc_output_dim(in_dim, num_posenc_frequencies), hidden,
                       2 * embedding_dim, activation, generator=generator, stack=replicas,
                       dtype=compute_dtype, output_dtype=torch.float32)

    def forward(self, x: torch.Tensor):
        out = self.mlp(positional_encoding(x, self.frequencies))
        d = self.embedding_dim
        return out[..., :d], out[..., d:] + self.logvar_offset


class FeatureEncoderBank(nn.Module):
    """All per-feature Gaussian encoders (positional encoding + MLP ->
    (mu, logvar)) as one batched module.

    Input: [B, sum(feature_dimensionalities)] concatenated features.
    Output: (mus, logvars), each [F, B, embedding_dim] and contiguous.
    ``logvar_offset`` shifts the predicted log-variances after the split.

    With ``replicas=R`` the bank is R banks (a sweep's members) run as one
    stack of R x F encoders, member r's F encoders at rows r*F..(r+1)*F:
    input [R, B, width], outputs [R, F, B, d]. A sequence of R CPU
    generators gives member r the weights the bank without replicas draws
    from the r-th.
    """

    def __init__(self, feature_dimensionalities: Sequence[int],
                 hidden: Sequence[int] = (128, 128), embedding_dim: int = 32,
                 num_posenc_frequencies: int = 4,
                 activation: str | Callable | None = "relu", logvar_offset: float = 0.0,
                 use_positional_encoding: bool = True,
                 generator: Generators = None, compute_dtype=None,
                 replicas: int | None = None):
        super().__init__()
        self.feature_dimensionalities = tuple(int(d) for d in feature_dimensionalities)
        self.embedding_dim = embedding_dim
        self.logvar_offset = float(logvar_offset)
        self.replicas = replicas
        nfreq = num_posenc_frequencies if use_positional_encoding else 0
        self.register_buffer(
            "frequencies",
            torch.from_numpy(positional_encoding_frequencies(nfreq)),
            persistent=False)
        max_dim = max(self.feature_dimensionalities)
        features = len(self.feature_dimensionalities)
        self.mlp = MLP(posenc_output_dim(max_dim, nfreq), hidden, 2 * embedding_dim,
                       activation, stack=features * (replicas or 1),
                       generator=generator, dtype=compute_dtype, output_dtype=torch.float32)

    def _split(self, out: torch.Tensor):
        d = self.embedding_dim
        return out[..., :d].contiguous(), out[..., d:] + self.logvar_offset

    def forward(self, x: torch.Tensor):
        stacked = pad_and_stack_features(x, self.feature_dimensionalities)   # [F, B, maxd]
        if self.replicas is not None:       # [F, R, B, maxd] -> [R * F, B, maxd]
            stacked = stacked.movedim(0, 1).flatten(0, 1)
        out = self.mlp(positional_encoding(stacked, self.frequencies))
        if self.replicas is not None:
            out = out.unflatten(0, (self.replicas, -1))
        return self._split(out)

    def encode_single(self, feature_index: int, x_feature: torch.Tensor):
        """Run one feature's encoder on raw single-feature data [B, dim_i]
        ([R, B, dim_i], or [B, dim_i] for every member, with replicas)."""
        pad = max(self.feature_dimensionalities) - self.feature_dimensionalities[feature_index]
        member = feature_index
        if self.replicas is not None:
            features = len(self.feature_dimensionalities)
            member = [r * features + feature_index for r in range(self.replicas)]
            if x_feature.dim() == 2:
                x_feature = x_feature.expand(self.replicas, *x_feature.shape)
        h = positional_encoding(F.pad(x_feature, (0, pad)), self.frequencies)
        return self._split(self.mlp(h, member=member))


class YEncoder(nn.Module):
    """Deterministic output-side encoder for InfoNCE training: positional
    encoding + MLP into the shared embedding space, its final layer float32
    (counterpart of ``dib_tpu/models/encoders.py::YEncoder``; ``in_dim`` is
    the width of y, which Flax infers)."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128, 128), shared_dim: int = 64,
                 num_posenc_frequencies: int = 4, posenc_start_power: int = 1,
                 activation: str | Callable | None = "relu", compute_dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.register_buffer(
            "frequencies",
            torch.from_numpy(positional_encoding_frequencies(num_posenc_frequencies,
                                                             posenc_start_power)),
            persistent=False)
        self.mlp = MLP(posenc_output_dim(in_dim, num_posenc_frequencies), hidden, shared_dim,
                       activation, generator=generator, dtype=compute_dtype,
                       output_dtype=torch.float32)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.mlp(positional_encoding(y, self.frequencies))


class SimpleBinaryEncoder(nn.Module):
    """Two-parameter encoder of a binary +-1 feature: x -> N(x * mu_scale,
    e^logvar), a trainable mean scale (initialised to 1) and a trainable
    log-variance shared by every input (initialised to ``logvar_init``).
    Input [B, 1]; outputs [B, d]."""

    def __init__(self, embedding_dim: int = 1, logvar_init: float = -3.0):
        super().__init__()
        self.mu_scale = nn.Parameter(torch.ones(1, embedding_dim))
        self.logvar = nn.Parameter(torch.full((1, embedding_dim), float(logvar_init)))

    def forward(self, x: torch.Tensor):
        mus = x * self.mu_scale
        return mus, self.logvar.expand(mus.shape)


class SimpleBinaryEncoderBank(nn.Module):
    """F :class:`SimpleBinaryEncoder` s as one module: parameters stacked
    over F (``mu_scale`` and ``logvar`` each [F, 1, d], the layout of the
    Flax bank's ``nn.vmap``), applied by broadcasting, with no loop over
    channels. Input [B, F] of +-1 values; outputs (mus, logvars), each
    [F, B, d]."""

    def __init__(self, num_features: int, embedding_dim: int = 1, logvar_init: float = -3.0):
        super().__init__()
        self.mu_scale = nn.Parameter(torch.ones(num_features, 1, embedding_dim))
        self.logvar = nn.Parameter(torch.full((num_features, 1, embedding_dim),
                                              float(logvar_init)))

    def forward(self, x: torch.Tensor):
        mus = x.transpose(0, 1)[..., None] * self.mu_scale          # [F, B, d]
        return mus, self.logvar.expand(mus.shape)
