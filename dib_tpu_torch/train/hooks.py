"""Instrumentation hooks (counterpart of ``dib_tpu/train/hooks.py``).

So far: the all-channels MI measurement, the paper's per-feature information
query on a fixed set of weights.
"""

from __future__ import annotations

import torch

from dib_tpu_torch.ops.gaussian import reparameterize
from dib_tpu_torch.ops.info_bounds import mi_sandwich_from_params


def all_features_bounds(model, rows, batch_size: int = 1024, num_batches: int = 8,
                        generator: torch.Generator | None = None,
                        idx: torch.Tensor | None = None, u: torch.Tensor | None = None):
    """Per-feature MI sandwich bounds of every channel at once.

    Draws ``num_batches`` evaluation batches of ``batch_size`` rows with
    replacement from ``rows`` ([n, width]), encodes each, and bounds all F
    channels of a batch in ONE kernel launch over the leading feature axis.
    Returns ([F] lower, [F] upper) in nats, averaged over the batches.

    ``idx`` ([num_batches, batch_size] row indices) and ``u``
    ([num_batches, F, batch_size, d] samples) replace the draws from
    ``generator`` (which must live on the model's device), so a test can
    replay another implementation's draws.
    """
    device = next(model.parameters()).device
    rows = torch.as_tensor(rows, dtype=torch.float32, device=device)
    lowers, uppers = [], []
    with torch.inference_mode():
        for b in range(num_batches):
            batch_idx = idx[b].to(device) if idx is not None else torch.randint(
                0, rows.shape[0], (batch_size,), generator=generator, device=device)
            mus, logvars = model.encode(rows[batch_idx])                 # [F, B, d]
            u_b = u[b].to(device) if u is not None else reparameterize(mus, logvars, generator)
            lower, upper = mi_sandwich_from_params(mus, logvars, u=u_b)  # [F] each
            lowers.append(lower)
            uppers.append(upper)
    return torch.stack(lowers).mean(0), torch.stack(uppers).mean(0)
