"""Basic MLP building blocks (counterpart of ``dib_tpu/models/mlp.py``).

Parameters keep Flax's layout and initialisation so a checkpoint of the JAX
package loads unchanged: a dense kernel is ``[in, out]`` (``[F, in, out]``
for a bank of F stacked layers), lecun-normal (a normal truncated at two
standard deviations, scaled by 1/sqrt(fan_in)), with a zero bias.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

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


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978   # std of N(0,1) cut at +-2
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Dense(nn.Module):
    """``x @ kernel + bias`` with a Flax-layout kernel; with ``stack=F`` the
    layer is F independent layers applied as one batched matmul to [F, B, in]."""

    def __init__(self, in_dim: int, out_dim: int, stack: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        lead = () if stack is None else (stack,)
        self.kernel = nn.Parameter(torch.empty(lead + (in_dim, out_dim)))
        self.bias = nn.Parameter(torch.zeros(lead + (out_dim,)))
        lecun_normal_(self.kernel, in_dim, generator)

    def forward(self, x: torch.Tensor, member: int | None = None) -> torch.Tensor:
        """[B, in] -> [B, out], or [F, B, in] -> [F, B, out] for a stack;
        ``member`` applies one layer of the stack to [B, in]."""
        kernel, bias = self.kernel, self.bias
        if member is not None:
            kernel, bias = kernel[member], bias[member]
        if kernel.dim() == 3:
            return torch.baddbmm(bias[:, None, :], x, kernel)
        return torch.matmul(x, kernel) + bias


class MLP(nn.Module):
    """Dense stack with a linear output layer.

    Args:
      in_dim: input width.
      hidden: widths of the hidden layers.
      output_dim: width of the final (linear unless output_activation) layer.
      activation: hidden-layer activation (name or callable).
      output_activation: optional activation on the output layer.
      stack: F for a bank of F independent MLPs run as batched matmuls.
      generator: CPU generator for the initialisation.
    """

    def __init__(self, in_dim: int, hidden: Sequence[int], output_dim: int,
                 activation: str | Callable | None = "relu",
                 output_activation: str | Callable | None = None,
                 stack: int | None = None, generator: torch.Generator | None = None):
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
