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
from dib_tpu_torch.models.mlp import MLP, Generators
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

    With ``replicas=R`` the model is R independent models (the members of a
    beta sweep): the encoder bank is one stack of R x F encoders, the
    integration MLP a stack of R, every input and output gains a leading
    [R] axis, and ``carve`` takes members out as a model of their own. A
    sequence of R generators gives replica r the weights the model without
    replicas draws from the r-th.
    """

    def __init__(self, feature_dimensionalities: Sequence[int],
                 encoder_hidden: Sequence[int] = (128, 128),
                 integration_hidden: Sequence[int] = (256, 256),
                 output_dim: int = 1, embedding_dim: int = 32,
                 use_positional_encoding: bool = True, num_posenc_frequencies: int = 4,
                 activation: str | Callable | None = "relu",
                 output_activation: str | Callable | None = None,
                 logvar_offset: float = 0.0, compute_dtype=None, *, device=None,
                 generator: Generators = None, replicas: int | None = None):
        # the architecture's arguments, from which ``carve`` builds a model
        architecture = {name: value for name, value in locals().items()
                        if name not in ("self", "device", "generator", "replicas", "__class__")}
        super().__init__()
        device = resolve_device(device)
        self.architecture = architecture
        self.replicas = replicas
        self.feature_dimensionalities = tuple(int(d) for d in feature_dimensionalities)
        self.compute_dtype = compute_dtype
        self.encoders = FeatureEncoderBank(
            self.feature_dimensionalities, encoder_hidden, embedding_dim,
            num_posenc_frequencies, activation=activation, logvar_offset=logvar_offset,
            use_positional_encoding=use_positional_encoding, generator=generator,
            compute_dtype=compute_dtype, replicas=replicas)
        self.integration = MLP(len(self.feature_dimensionalities) * embedding_dim,
                               integration_hidden, output_dim, activation,
                               output_activation, stack=replicas, generator=generator,
                               dtype=compute_dtype, output_dtype=torch.float32)
        self.to(device)

    @property
    def num_features(self) -> int:
        return len(self.feature_dimensionalities)

    def noise_shape(self, batch: int) -> tuple[int, ...]:
        """Shape of the standard-normal noise one forward draws: [F, B, d]
        ([R, F, B, d] with replicas)."""
        lead = () if self.replicas is None else (self.replicas,)
        return lead + (self.num_features, batch, self.encoders.embedding_dim)

    def forward(self, x: torch.Tensor, sample: bool = True,
                generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        """``sample=False`` is the posterior mean (u = mus); otherwise u is
        drawn from ``generator``, or built from the injected noise ``eps``
        ([F, B, d]). With replicas, x is [R, B, width] and every output
        gains a leading [R]."""
        mus, logvars = self.encoders(x)                               # [F, B, d] each
        u = reparameterize(mus, logvars, generator, eps) if sample else mus
        # KL per channel: sum over latent dim, mean over batch
        kl_per_feature = kl_diagonal_gaussian(mus, logvars).mean(dim=-1)
        embeddings = u.transpose(-3, -2).flatten(-2)                  # [B, F*d]
        prediction = self.integration(embeddings)
        aux = {"kl_per_feature": kl_per_feature, "mus": mus, "logvars": logvars,
               "embeddings": embeddings}
        return prediction, aux

    def encode(self, x: torch.Tensor):
        """Channel parameters only (no sampling/prediction): [F, B, d] each."""
        return self.encoders(x)

    def encode_feature(self, feature_index: int, x_feature: torch.Tensor):
        """One feature's channel parameters from raw single-feature data:
        [B, d] each ([R, B, d] with replicas, every replica on the same rows
        for a [B, dim] input)."""
        return self.encoders.encode_single(feature_index, x_feature)

    def member_axis(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """A view of a stacked tensor laid out like parameter ``name`` (the
        parameter, or its Adam moments) that leads with R: the encoder
        bank's leaves lead with R x F, the others with R."""
        return value.unflatten(0, (self.replicas, -1)) if name.startswith("encoders.") else value

    def member_values(self, name: str, value: torch.Tensor, members) -> torch.Tensor:
        """Members ``members`` (an int or a list) of a stacked tensor laid
        out like parameter ``name``, in the parameter's own layout."""
        value = self.member_axis(name, value)
        if name.startswith("encoders.") and not isinstance(members, int):
            return value[members].flatten(0, 1)
        return value[members]

    def carve(self, members: int | Sequence[int]) -> "DistributedIBModel":
        """A copy of some members of a model with replicas, on its device:
        for an int r, a model without replicas holding replica r's weights;
        for a sequence, a model whose replicas are those members in order."""
        if self.replicas is None:
            raise ValueError("carve takes members out of a model with replicas")
        single = isinstance(members, int)
        index = members if single else list(members)
        model = DistributedIBModel(**self.architecture, device=next(self.parameters()).device,
                                   generator=torch.Generator(),   # overwritten below
                                   replicas=None if single else len(index))
        model.load_state_dict({name: self.member_values(name, value, index)
                               for name, value in self.state_dict().items()})
        return model
