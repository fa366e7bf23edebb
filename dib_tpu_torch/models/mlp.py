"""Basic MLP building blocks (counterpart of ``dib_tpu/models/mlp.py``).

Parameters keep Flax's layout and initialisation so a checkpoint of the JAX
package loads unchanged: a dense kernel is ``[in, out]`` (``[F, in, out]``
for a bank of F stacked layers), lecun-normal (a normal truncated at two
standard deviations, scaled by 1/sqrt(fan_in)), with a zero bias.

A beta sweep's R replicas of a layer are such a stack of R: every parameter
with a leading [R] axis (the layout of a JAX sweep's stacked tree), mapping
[R, ..., in] to [R, ..., out] in one batched matmul.

A layer's ``dtype`` is its computation type, as Flax's ``dtype``: the
parameters stay float32, and the input, kernel and bias are cast to it (Flax's
``promote_dtype``), multiplied, and the bias added in that type, so a
bfloat16 layer rounds ``x @ kernel`` to bfloat16 before the bias add, as
Flax does.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def resolve_dtype(dtype) -> torch.dtype | None:
    """A computation dtype: ``None`` (no cast), a ``torch.dtype`` or its name
    ('bfloat16', 'float32', ...).

    A 16-bit type also sets ``torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction`` and its float16 twin to False,
    for the whole process: cuBLAS then reduces 16-bit products in float32,
    as the JAX package does (``preferred_element_type``), and the port's
    numerics do not depend on which GEMM cuBLAS picks.
    """
    if dtype is None:
        return None
    resolved = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype) or not resolved.is_floating_point:
        raise ValueError(f"Unknown compute dtype {dtype!r}")
    if resolved.itemsize == 2:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return resolved


def _identity(x):
    return x


# Flax multiplies by the slope in x's dtype: 0.1 rounds to 0.10009765625 in bfloat16
_LEAKY_SLOPES = {dtype: float(torch.tensor(0.1, dtype=dtype))
                 for dtype in (torch.float32, torch.bfloat16, torch.float16)}


def _leaky_relu(x):
    return F.leaky_relu(x, negative_slope=_LEAKY_SLOPES.get(x.dtype, 0.1))


def _rounded(value: float, dtype: torch.dtype) -> float:
    """A weakly typed constant as Flax multiplies it: rounded to x's dtype."""
    return float(torch.tensor(value, dtype=dtype))


def _gelu(x):
    """Flax's ``nn.gelu`` (the tanh approximation). In a 16-bit type it is
    composed as ``jax.nn.gelu`` composes it, each operation rounding to that
    type as XLA rounds it (x ** 3 as x * x * x)."""
    if x.dtype.itemsize != 2:
        return F.gelu(x, approximate="tanh")
    c, k = _rounded(math.sqrt(2.0 / math.pi), x.dtype), _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _sigmoid(x):
    """``jax.nn.sigmoid``: XLA expands the logistic to 1 / (1 + exp(-x)),
    which in a 16-bit type rounds after each operation."""
    if x.dtype.itemsize != 2:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


# tanh is one operation in XLA too: computed in float32 and rounded once
_ACTIVATIONS = {
    "relu": torch.relu,
    "leaky_relu": _leaky_relu,
    "tanh": torch.tanh,
    "gelu": _gelu,
    "sigmoid": _sigmoid,
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
    A sequence of R generators splits the leading axis into R equal blocks
    and fills the r-th from the r-th generator (a stack of R x F layers:
    member r's F layers, drawn as the module without replicas draws them)."""
    if isinstance(generator, Sequence):
        if not generator or tensor.shape[0] % len(generator):
            raise ValueError(f"{len(generator)} generators for a stack of {tensor.shape[0]}")
        for member, member_generator in zip(tensor.unflatten(0, (len(generator), -1)),
                                            generator):
            lecun_normal_(member, fan_in, member_generator)
        return tensor
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978   # std of N(0,1) cut at +-2
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Dense(nn.Module):
    """``x @ kernel + bias`` with a Flax-layout kernel, computed in ``dtype``
    (``None``: the input's); with ``stack=F`` the layer is F independent
    layers applied as one batched matmul to [F, ..., in]."""

    def __init__(self, in_dim: int, out_dim: int, stack: int | None = None,
                 generator: Generators = None, dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        lead = () if stack is None else (stack,)
        self.kernel = nn.Parameter(torch.empty(lead + (in_dim, out_dim)))
        self.bias = nn.Parameter(torch.zeros(lead + (out_dim,)))
        lecun_normal_(self.kernel, in_dim, generator)

    def forward(self, x: torch.Tensor, member: int | Sequence[int] | None = None) -> torch.Tensor:
        """[B, in] -> [B, out], or [F, ..., in] -> [F, ..., out] for a stack;
        ``member`` applies one layer of the stack to [B, in], or a list of K
        layers to [K, B, in]."""
        kernel, bias = self.kernel, self.bias
        if member is not None:
            kernel, bias = kernel[member], bias[member]
        if self.dtype is not None:
            x, kernel, bias = x.to(self.dtype), kernel.to(self.dtype), bias.to(self.dtype)
        if kernel.dim() == 3:
            flat = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), kernel) + bias[:, None, :]
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
      dtype: computation dtype of the layers (parameters stay float32);
        the activations run in it too.
      output_dtype: the final layer's (``None``: ``dtype``); float32 where
        the output feeds a loss, a KL or an MI bound.
    """

    def __init__(self, in_dim: int, hidden: Sequence[int], output_dim: int,
                 activation: str | Callable | None = "relu",
                 output_activation: str | Callable | None = None,
                 stack: int | None = None, generator: Generators = None,
                 dtype=None, output_dtype=None):
        super().__init__()
        widths = [in_dim, *hidden, output_dim]
        dtypes = [dtype] * len(hidden) + [dtype if output_dtype is None else output_dtype]
        self.layers = nn.ModuleList(
            Dense(a, b, stack, generator, layer_dtype)
            for a, b, layer_dtype in zip(widths[:-1], widths[1:], dtypes))
        self.activation = resolve_activation(activation)
        self.output_activation = resolve_activation(output_activation)

    def forward(self, x: torch.Tensor, member: int | Sequence[int] | None = None) -> torch.Tensor:
        """Apply the stack; ``member`` selects one MLP of a bank for [B, in]
        (a list of K selects K of them for [K, B, in])."""
        *hidden, last = self.layers
        for layer in hidden:
            x = self.activation(layer(x, member))
        return self.output_activation(last(x, member))
