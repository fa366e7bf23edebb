"""Model families of the port: the Distributed IB core and the per-particle
set-transformer model."""

from dib_tpu_torch.models.dib import DistributedIBModel
from dib_tpu_torch.models.encoders import (
    FeatureEncoderBank,
    GaussianEncoder,
    SimpleBinaryEncoder,
    SimpleBinaryEncoderBank,
    YEncoder,
    pad_and_stack_features,
)
from dib_tpu_torch.models.mlp import MLP, Dense, resolve_activation
from dib_tpu_torch.models.per_particle import PerParticleDIBModel
from dib_tpu_torch.models.set_transformer import (
    MultiHeadSelfAttention,
    SetAttentionBlock,
    SetTransformer,
)
