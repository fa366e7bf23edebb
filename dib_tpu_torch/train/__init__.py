"""Training-side pieces of the port; so far the MI measurement hook."""

from dib_tpu_torch.train.hooks import all_features_bounds
