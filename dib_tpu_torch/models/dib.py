"""The flagship Distributed IB model (counterpart of ``dib_tpu/models/dib.py``).

The model returns everything the training step and the instrumentation need:
the prediction, per-feature KL and the Gaussian channel parameters. Beta
never lives inside the model.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.models.encoders import FeatureEncoderBank
from dib_tpu_torch.models.mlp import MLP
from dib_tpu_torch.ops.gaussian import kl_diagonal_gaussian, reparameterize


class DistributedIBModel(nn.Module):
    """Per-feature Gaussian encoders -> reparameterized samples -> integration MLP.

    ``forward`` returns ``(prediction, aux)`` where aux carries:
      - ``kl_per_feature``: [F] batch-mean KL (nats) of each channel
      - ``mus`` / ``logvars``: [F, B, d] channel parameters
      - ``embeddings``: [B, F * d] the feature-major concatenated samples fed
        to the integration network

    Parameters are initialised on the CPU from ``generator`` (Flax's
    lecun-normal, zero bias) and then moved to ``device`` (``None`` means the
    GPU), so one seed gives the same weights on every device.

    ``compute_dtype`` ('bfloat16') runs the matmuls in that type; the
    parameters, KL, sampling and the prediction stay float32.
    """

    def __init__(self, feature_dimensionalities: Sequence[int],
                 encoder_hidden: Sequence[int] = (128, 128),
                 integration_hidden: Sequence[int] = (256, 256),
                 output_dim: int = 1, embedding_dim: int = 32,
                 use_positional_encoding: bool = True, num_posenc_frequencies: int = 4,
                 activation: str | Callable | None = "relu",
                 output_activation: str | Callable | None = None,
                 logvar_offset: float = 0.0, compute_dtype=None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.feature_dimensionalities = tuple(int(d) for d in feature_dimensionalities)
        self.compute_dtype = compute_dtype
        self.encoders = FeatureEncoderBank(
            self.feature_dimensionalities, encoder_hidden, embedding_dim,
            num_posenc_frequencies, activation=activation, logvar_offset=logvar_offset,
            use_positional_encoding=use_positional_encoding, generator=generator,
            compute_dtype=compute_dtype)
        self.integration = MLP(len(self.feature_dimensionalities) * embedding_dim,
                               integration_hidden, output_dim, activation,
                               output_activation, generator=generator, dtype=compute_dtype,
                               output_dtype=torch.float32)
        self.to(device)

    @property
    def num_features(self) -> int:
        return len(self.feature_dimensionalities)

    def noise_shape(self, batch: int) -> tuple[int, int, int]:
        """Shape of the standard-normal noise one forward draws: [F, B, d]."""
        return (self.num_features, batch, self.encoders.embedding_dim)

    def forward(self, x: torch.Tensor, sample: bool = True,
                generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        """``sample=False`` is the posterior mean (u = mus); otherwise u is
        drawn from ``generator``, or built from the injected noise ``eps``
        ([F, B, d])."""
        mus, logvars = self.encoders(x)                               # [F, B, d] each
        u = reparameterize(mus, logvars, generator, eps) if sample else mus
        # KL per channel: sum over latent dim, mean over batch
        kl_per_feature = kl_diagonal_gaussian(mus, logvars).mean(dim=-1)
        embeddings = u.transpose(0, 1).reshape(x.shape[0], -1)       # [B, F*d]
        prediction = self.integration(embeddings)
        aux = {"kl_per_feature": kl_per_feature, "mus": mus, "logvars": logvars,
               "embeddings": embeddings}
        return prediction, aux

    def encode(self, x: torch.Tensor):
        """Channel parameters only (no sampling/prediction): [F, B, d] each."""
        return self.encoders(x)

    def encode_feature(self, feature_index: int, x_feature: torch.Tensor):
        """One feature's channel parameters from raw single-feature data."""
        return self.encoders.encode_single(feature_index, x_feature)
