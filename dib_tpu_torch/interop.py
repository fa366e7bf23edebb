"""Parameter exchange with the JAX package's Flax checkpoints.

Each of the port's parameters has one Flax counterpart, in the same layout;
only the names differ. A Flax ``DistributedIBModel`` keeps

    params/encoders/VmapGaussianEncoder_0/MLP_0/Dense_k/{kernel [F, in, out], bias [F, out]}
    params/integration/Dense_k/{kernel [in, out], bias [out]}

a Flax ``PerParticleDIBModel``

    params/particle_encoder/MLP_0/Dense_k/{kernel, bias}
    params/aggregator/SetAttentionBlock_i/MultiHeadSelfAttention_0/
        {query, key, value, out | qkv}/{kernel, bias}
    params/aggregator/SetAttentionBlock_i/{LayerNorm_0, LayerNorm_1}/{scale, bias}
    params/aggregator/SetAttentionBlock_i/MLP_0/Dense_k/{kernel, bias}
    params/aggregator/Dense_k/{kernel, bias}

the boolean workload's Flax ``BooleanDIBModel``

    params/encoders/VmapSimpleBinaryEncoder_0/{mu_scale, logvar} [F, 1, d]
    params/integration/Dense_k/{kernel, bias}

a Flax ``SetTransformer`` on its own the ``aggregator`` subtree, and a Flax
``YEncoder`` (or ``GaussianEncoder``) on its own ``MLP_0/Dense_k``. The
trees here hold numpy arrays (``jax.device_get`` of a Flax tree, or an Orbax
restore).

A beta sweep's stacked tree (every leaf [R, ...], as ``jax.vmap`` of
``init`` gives it) has the same paths, and a model with ``replicas=R`` the
same names with a leading [R] on each tensor, so both functions map one to
the other; the one reshape is the encoder bank of a ``DistributedIBModel``
with replicas, one stack of R x F in the port and [R, F, ...] in the tree.
``replica=r`` maps member r alone, from a stacked tree to a model without
replicas or from a model with replicas to a tree without.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

# (port state-dict name, Flax path under 'params'); {name} matches one path
# component. The port's LayerNorm 'weight' is Flax's 'scale'.
_SET_TRANSFORMER = (
    ("blocks.{i}.attention.{proj}.{leaf}",
     "SetAttentionBlock_{i}/MultiHeadSelfAttention_0/{proj}/{leaf}"),
    ("blocks.{i}.norm{n}.weight", "SetAttentionBlock_{i}/LayerNorm_{n}/scale"),
    ("blocks.{i}.norm{n}.bias", "SetAttentionBlock_{i}/LayerNorm_{n}/bias"),
    ("blocks.{i}.ff.layers.{k}.{leaf}", "SetAttentionBlock_{i}/MLP_0/Dense_{k}/{leaf}"),
    ("head.layers.{k}.{leaf}", "Dense_{k}/{leaf}"),
)
_RULES = (
    ("encoders.mlp.layers.{k}.{leaf}", "encoders/VmapGaussianEncoder_0/MLP_0/Dense_{k}/{leaf}"),
    ("encoders.{leaf}", "encoders/VmapSimpleBinaryEncoder_0/{leaf}"),    # the binary bank
    ("integration.layers.{k}.{leaf}", "integration/Dense_{k}/{leaf}"),
    ("particle_encoder.mlp.layers.{k}.{leaf}", "particle_encoder/MLP_0/Dense_{k}/{leaf}"),
    ("mlp.layers.{k}.{leaf}", "MLP_0/Dense_{k}/{leaf}"),    # a YEncoder on its own
    *((f"aggregator.{port}", f"aggregator/{flax}") for port, flax in _SET_TRANSFORMER),
    *_SET_TRANSFORMER,     # a SetTransformer on its own
)


def _pattern(template: str, sep: str) -> re.Pattern:
    parts = re.split(r"(\{\w+\})", template)
    return re.compile("".join(
        f"(?P<{p[1:-1]}>[^{re.escape(sep)}]+)" if p.startswith("{") else re.escape(p)
        for p in parts) + "$")


_PORT = [(_pattern(port, "."), flax) for port, flax in _RULES]
_FLAX = [(_pattern(flax, "/"), port) for port, flax in _RULES]


def _translate(name: str, rules) -> str | None:
    for pattern, template in rules:
        match = pattern.match(name)
        if match:
            return template.format(**match.groupdict())
    return None


def _flatten(node, prefix: str = ""):
    for key, value in node.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) and value:
            yield from _flatten(value, path + "/")
        else:
            yield path, value


_BANK = "encoders/VmapGaussianEncoder_0/"
_BANK_RANK = {"kernel": 3, "bias": 2}     # [F, in, out] and [F, out] without replicas


def params_from_flax(tree, replica: int | None = None) -> dict[str, torch.Tensor]:
    """Flax model variables -> the port's state dict (of member ``replica``
    of a stacked tree, if given)."""
    state = {}
    for path, value in _flatten(tree["params"]):
        name = _translate(path, _FLAX)
        if name is None:
            raise ValueError(f"unexpected Flax parameter {path!r}: the port has only Dense_<k>, "
                             "LayerNorm_<k> and attention projection layers")
        value = np.array(value, dtype=np.float32)
        if replica is not None:
            value = value[replica]
        if path.startswith(_BANK) and value.ndim > _BANK_RANK[path.rsplit("/", 1)[1]]:
            value = value.reshape(-1, *value.shape[2:])      # [R, F, ...] -> [R * F, ...]
        state[name] = torch.from_numpy(value)
    return state


def params_to_flax(model_or_state, replica: int | None = None) -> dict:
    """The port's model (or its state dict) -> Flax variables of numpy
    arrays (of member ``replica`` of a model with replicas, if given). A
    ``DistributedIBModel`` with replicas must come as the model, whose
    ``replicas`` splits its encoder bank's stack."""
    replicas = None
    if isinstance(model_or_state, nn.Module):
        replicas = getattr(model_or_state, "replicas", None)
        state = model_or_state.state_dict()
    else:
        state = model_or_state
    params: dict = {}
    for name, value in state.items():
        path = _translate(name, _PORT)
        if path is None:
            raise ValueError(f"unexpected parameter {name!r}: no counterpart in a Flax tree")
        if path.startswith(_BANK) and replicas is not None:
            value = value.unflatten(0, (replicas, -1))      # [R * F, ...] -> [R, F, ...]
        *parents, leaf = path.split("/")
        node = params
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = (value if replica is None else value[replica]).detach().cpu().numpy()
    return {"params": params}
