"""Basic MLP building blocks (counterpart of ``dib_tpu/models/mlp.py``).

Parameters keep Flax's layout and initialisation so a checkpoint of the JAX
package loads unchanged: a dense kernel is ``[in, out]`` (``[F, in, out]``
for a bank of F stacked layers), lecun-normal (a normal truncated at two
standard deviations, scaled by 1/sqrt(fan_in)), with a zero bias.

A beta sweep's R replicas of a layer are such a stack of R: every parameter
with a leading [R] axis (the layout of a JAX sweep's stacked tree), mapping
[R, ..., in] to [R, ..., out] in one batched matmul.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def _identity(x):
    return x


_ACTIVATIONS = {
    "relu": torch.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax's nn.gelu default
    "sigmoid": torch.sigmoid,
    "none": _identity,
    "linear": _identity,
}


def resolve_activation(activation) -> Callable:
    """Accepts a callable or a name ('relu', 'leaky_relu', 'tanh', None)."""
    if activation is None:
        return _identity
    if callable(activation):
        return activation
    if activation not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {activation!r}")
    return _ACTIVATIONS[activation]


# One CPU generator, or one per member of a stack: member r of a module built
# from a sequence then draws what the module without a stack draws from the
# r-th.
Generators = Union[torch.Generator, Sequence[torch.Generator], None]


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Generators = None) -> torch.Tensor:
    """Flax's ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in.
    A sequence of generators fills ``tensor[r]`` from the r-th."""
    if isinstance(generator, Sequence):
        if len(generator) != tensor.shape[0]:
            raise ValueError(f"{len(generator)} generators for {tensor.shape[0]} replicas")
        for member, member_generator in zip(tensor, generator):
            lecun_normal_(member, fan_in, member_generator)
        return tensor
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978   # std of N(0,1) cut at +-2
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Dense(nn.Module):
    """``x @ kernel + bias`` with a Flax-layout kernel; with ``stack=F`` the
    layer is F independent layers applied as one batched matmul to
    [F, ..., in]."""

    def __init__(self, in_dim: int, out_dim: int, stack: int | None = None,
                 generator: Generators = None):
        super().__init__()
        lead = () if stack is None else (stack,)
        self.kernel = nn.Parameter(torch.empty(lead + (in_dim, out_dim)))
        self.bias = nn.Parameter(torch.zeros(lead + (out_dim,)))
        lecun_normal_(self.kernel, in_dim, generator)

    def forward(self, x: torch.Tensor, member: int | None = None) -> torch.Tensor:
        """[B, in] -> [B, out], or [F, ..., in] -> [F, ..., out] for a stack;
        ``member`` applies one layer of the stack to [B, in]."""
        kernel, bias = self.kernel, self.bias
        if member is not None:
            kernel, bias = kernel[member], bias[member]
        if kernel.dim() == 3:
            flat = torch.baddbmm(bias[:, None, :], x.reshape(x.shape[0], -1, x.shape[-1]),
                                 kernel)
            return flat.reshape(*x.shape[:-1], flat.shape[-1])
        return torch.matmul(x, kernel) + bias


class MLP(nn.Module):
    """Dense stack with a linear output layer.

    Args:
      in_dim: input width.
      hidden: widths of the hidden layers.
      output_dim: width of the final (linear unless output_activation) layer.
      activation: hidden-layer activation (name or callable).
      output_activation: optional activation on the output layer.
      stack: F for a bank of F independent MLPs run as batched matmuls
        over a leading axis of the input (a sweep's R replicas).
      generator: CPU generator for the initialisation (one per member of
        the stack, or one for all).
    """

    def __init__(self, in_dim: int, hidden: Sequence[int], output_dim: int,
                 activation: str | Callable | None = "relu",
                 output_activation: str | Callable | None = None,
                 stack: int | None = None, generator: Generators = None):
        super().__init__()
        widths = [in_dim, *hidden, output_dim]
        self.layers = nn.ModuleList(
            Dense(a, b, stack, generator) for a, b in zip(widths[:-1], widths[1:]))
        self.activation = resolve_activation(activation)
        self.output_activation = resolve_activation(output_activation)

    def forward(self, x: torch.Tensor, member: int | None = None) -> torch.Tensor:
        """Apply the stack; ``member`` selects one MLP of a bank for [B, in]."""
        *hidden, last = self.layers
        for layer in hidden:
            x = self.activation(layer(x, member))
        return self.output_activation(last(x, member))
