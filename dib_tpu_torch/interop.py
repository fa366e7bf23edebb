"""Parameter exchange with the JAX package's Flax checkpoints.

A Flax ``DistributedIBModel`` keeps its variables as

    {'params': {'encoders': {'VmapGaussianEncoder_0': {'MLP_0': {
                    'Dense_k': {'kernel': [F, in, out], 'bias': [F, out]}}}},
                'integration': {'Dense_k': {'kernel': [in, out], 'bias': [out]}}}}

and the port's model keeps the same arrays, in the same layout, under
``encoders.mlp.layers.k.*`` and ``integration.layers.k.*``. The trees here
hold numpy arrays (``jax.device_get`` of a Flax tree, or an Orbax restore).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_BANK = ("encoders", "VmapGaussianEncoder_0", "MLP_0")
_INTEGRATION = ("integration",)
_PREFIXES = {_BANK: "encoders.mlp", _INTEGRATION: "integration"}


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """Flax ``DistributedIBModel`` variables -> the port's state dict."""
    state = {}
    for path, prefix in _PREFIXES.items():
        node = tree["params"]
        for key in path:
            node = node[key]
        for name, layer in node.items():
            index = _dense_index(name)
            for leaf in ("kernel", "bias"):
                state[f"{prefix}.layers.{index}.{leaf}"] = torch.from_numpy(
                    np.array(layer[leaf], dtype=np.float32))
    return state


def params_to_flax(model_or_state) -> dict:
    """The port's model (or its state dict) -> Flax variables of numpy arrays."""
    state = (model_or_state.state_dict() if isinstance(model_or_state, nn.Module)
             else model_or_state)
    params: dict = {}
    for path, prefix in _PREFIXES.items():
        node = params
        for key in path:
            node = node.setdefault(key, {})
        for name, value in state.items():
            if not name.startswith(prefix + ".layers."):
                continue
            index, leaf = name[len(prefix) + len(".layers."):].split(".")
            node.setdefault(f"Dense_{index}", {})[leaf] = value.detach().cpu().numpy()
    return {"params": params}


def _dense_index(name: str) -> int:
    if not name.startswith("Dense_"):
        raise ValueError(f"unexpected Flax layer {name!r}; expected Dense_<k>")
    return int(name[len("Dense_"):])
