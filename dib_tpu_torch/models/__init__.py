"""Model families of the port: the Distributed IB core so far."""

from dib_tpu_torch.models.dib import DistributedIBModel
from dib_tpu_torch.models.encoders import FeatureEncoderBank, pad_and_stack_features
from dib_tpu_torch.models.mlp import MLP, Dense, resolve_activation
