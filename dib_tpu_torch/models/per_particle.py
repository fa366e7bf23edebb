"""Per-particle Distributed IB: one shared particle bottleneck + a set
transformer (counterpart of ``dib_tpu/models/per_particle.py``).

The amorphous-plasticity flagship: ONE Gaussian encoder shared by every
particle of a neighborhood compresses each particle's engineered features
into a latent channel; the sampled particle codes feed a permutation-
invariant set transformer that predicts whether the neighborhood is a
rearrangement locus. The KL penalty sums over latent dimensions and
particles (the trainer sums ``kl_per_feature``), mean over the batch.
"Features" are the particle slots, so the trainer and the MI hook treat
this model as they treat ``DistributedIBModel``.

With ``replicas=R`` the model is R independent models (the members of a
beta sweep): every parameter has a leading [R] axis under its usual name,
every input and output a leading [R] axis, and ``carve`` takes members out
as a model of their own.

``compute_dtype='bfloat16'`` (the north star's setting) runs the encoder's
hidden layers and the set transformer's matmuls and attention in bfloat16;
the parameters, the channel parameters, KL, sampling, LayerNorms, residual
sums and the logit stay float32.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.models.encoders import GaussianEncoder
from dib_tpu_torch.models.mlp import Generators
from dib_tpu_torch.models.set_transformer import SetTransformer
from dib_tpu_torch.ops.gaussian import kl_diagonal_gaussian, reparameterize


class PerParticleDIBModel(nn.Module):
    """[B, P*F] (or [B, P, F]) neighborhoods -> locus logit, per-particle KL.

    Defaults are the flagship: 50 particles x 12 features, encoder MLP
    (128, 128) -> 2 x 32 with logvar offset -3, no positional encoding, set
    transformer of 6 blocks x 12 heads x key_dim 128 (1,293,505 parameters),
    float32 compute unless ``compute_dtype`` is set.
    Parameters are initialised on the CPU from ``generator`` (Flax's
    schemes) and moved to ``device`` (``None`` means the GPU). With
    ``replicas=R`` and a sequence of R generators, replica r holds the
    weights the model without replicas draws from the r-th generator.
    """

    def __init__(self, num_particles: int = 50, particle_feature_dim: int = 12,
                 encoder_hidden: Sequence[int] = (128, 128), embedding_dim: int = 32,
                 logvar_offset: float = -3.0, num_posenc_frequencies: int = 0,
                 num_blocks: int = 6, num_heads: int = 12, key_dim: int = 128,
                 ff_hidden: Sequence[int] = (128,), head_hidden: Sequence[int] = (256,),
                 output_dim: int = 1, activation: str | Callable | None = "relu",
                 compute_dtype=None, use_flash: bool | None = None, flash_min_seq: int = 1024,
                 fuse_qkv: bool = False, remat: bool = False, *, device=None,
                 generator: Generators = None, replicas: int | None = None):
        # the architecture's arguments, from which ``carve`` builds a model
        architecture = {name: value for name, value in locals().items()
                        if name not in ("self", "device", "generator", "replicas", "__class__")}
        super().__init__()
        device = resolve_device(device)
        self.architecture = architecture
        self.replicas = replicas
        self.num_particles = num_particles
        self.particle_feature_dim = particle_feature_dim
        self.embedding_dim = embedding_dim
        self.particle_encoder = GaussianEncoder(
            particle_feature_dim, encoder_hidden, embedding_dim, num_posenc_frequencies,
            activation=activation, logvar_offset=logvar_offset, generator=generator,
            replicas=replicas, compute_dtype=compute_dtype)
        self.aggregator = SetTransformer(
            num_blocks, num_heads, key_dim, embedding_dim, ff_hidden, head_hidden, output_dim,
            use_flash=use_flash, flash_min_seq=flash_min_seq, fuse_qkv=fuse_qkv, remat=remat,
            compute_dtype=compute_dtype, device=device, generator=generator, replicas=replicas)
        self.to(device)

    @property
    def num_features(self) -> int:
        return self.num_particles

    def noise_shape(self, batch: int) -> tuple[int, ...]:
        """Shape of the standard-normal noise one forward draws: [B, P, d]
        ([R, B, P, d] with replicas)."""
        lead = () if self.replicas is None else (self.replicas,)
        return lead + (batch, self.num_particles, self.embedding_dim)

    def _sets(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:1 if self.replicas is None else 2]
        return x.reshape(*lead, self.num_particles, self.particle_feature_dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None, sample: bool = True):
        """Returns ``(prediction, aux)``; aux carries ``kl_per_feature`` [P]
        (KL summed over latent dims, mean over the batch), ``mus``/``logvars``
        [P, B, d] and ``embeddings`` [B, P*d]. ``sample=False`` feeds the
        posterior means; otherwise u is drawn from ``generator``, or built
        from the injected noise ``eps`` ([B, P, d]). With replicas, x is
        [R, B, P*F] and every output gains a leading [R]."""
        mus, logvars = self.particle_encoder(self._sets(x))      # [B, P, d] each
        u = reparameterize(mus, logvars, generator, eps) if sample else mus
        kl_per_feature = kl_diagonal_gaussian(mus, logvars).mean(dim=-2)
        prediction = self.aggregator(u)
        aux = {"kl_per_feature": kl_per_feature, "mus": mus.transpose(-3, -2),
               "logvars": logvars.transpose(-3, -2), "embeddings": u.flatten(-2)}
        return prediction, aux

    def encode(self, x: torch.Tensor):
        """Channel parameters of every particle slot: [P, B, d] each
        ([R, P, B, d] with replicas)."""
        mus, logvars = self.particle_encoder(self._sets(x))
        return mus.transpose(-3, -2), logvars.transpose(-3, -2)

    def encode_feature(self, feature_index: int, x_feature: torch.Tensor):
        """Channel parameters from raw per-particle data [B, F]: [B, d] each,
        or [R, B, d] with replicas, every replica encoding the same rows (a
        [R, B, F] input gives each replica its own). Every slot shares the
        encoder, so ``feature_index`` only names the slot."""
        del feature_index
        if self.replicas is not None and x_feature.dim() == 2:
            x_feature = x_feature.expand(self.replicas, *x_feature.shape)
        return self.particle_encoder(x_feature)

    def carve(self, members: int | Sequence[int]) -> "PerParticleDIBModel":
        """A copy of some members of a model with replicas, on its device:
        for an int r, a model without replicas holding replica r's weights;
        for a sequence, a model whose replicas are those members in order."""
        if self.replicas is None:
            raise ValueError("carve takes members out of a model with replicas")
        single = isinstance(members, int)
        index = members if single else list(members)
        model = PerParticleDIBModel(**self.architecture, device=next(self.parameters()).device,
                                    generator=torch.Generator(),   # overwritten below
                                    replicas=None if single else len(index))
        model.load_state_dict({name: value[index] for name, value in self.state_dict().items()})
        return model

    def member_axis(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """A stacked tensor laid out like parameter ``name``, leading with R
        (every leaf does)."""
        del name
        return value

    def member_values(self, name: str, value: torch.Tensor, members) -> torch.Tensor:
        """Members ``members`` of a stacked tensor laid out like parameter
        ``name`` (every leaf leads with R)."""
        del name
        return value[members]
