"""Set-transformer aggregator for per-particle (permutation-invariant)
workloads (counterpart of ``dib_tpu/models/set_transformer.py``).

Post-LN attention blocks (multi-head self-attention, residual, LayerNorm,
feed-forward, residual, LayerNorm), mean pool over the set, a head MLP and a
linear output. Parameters keep Flax's layouts so a checkpoint of the JAX
package loads unchanged (``dib_tpu_torch.interop``):

  - ``query``/``key``/``value`` kernels [in, H, D] with biases [H, D], and
    ``out`` [H, D, out] with bias [out] (Flax's ``DenseGeneral``), or with
    ``fuse_qkv`` one ``qkv`` kernel [in, 3, H, D] with bias [3, H, D];
  - LayerNorm ``weight``/``bias`` (Flax's ``scale``/``bias``), eps 1e-6 as
    in Flax (PyTorch's default is 1e-5).

The attention core is the flash kernel (``ops.attention``) when
``use_flash`` is True, or when it is None and the set holds at least
``flash_min_seq`` elements on a CUDA tensor; the dense version otherwise.
Sets sharded over several devices (the JAX package's ``seq_axis``) are not
ported.

With ``replicas=R`` every module holds R independent copies of its
parameters (a leading [R] axis on each, names unchanged) and takes inputs
[R, B, S, model_dim]. Attention has no weights, so R is folded into its
batch axis: one dense call or one flash launch serves every replica.

``compute_dtype`` ('bfloat16') runs the projections, the attention core (the
flash kernel's tensor-core path), the feed-forward MLP and the head's hidden
layers in that type, as the JAX package's mixed-precision recipe does; the
residual sums, LayerNorms, the mean pool and the logits stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.models.mlp import MLP, Generators, lecun_normal_, resolve_dtype
from dib_tpu_torch.ops.attention import dense_self_attention, flash_self_attention

LAYER_NORM_EPS = 1e-6     # Flax's LayerNorm default


class DenseGeneral(nn.Module):
    """Flax's ``DenseGeneral``: ``x @ kernel + bias`` over a kernel of shape
    ``[*in_shape, *out_shape]``, contracting the last ``len(in_shape)`` axes
    of x. Lecun-normal with fan-in = prod(in_shape), zero bias, computed in
    ``dtype`` as ``Dense`` is. With ``replicas=R``, R independent layers
    over x's leading axis."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 generator: Generators = None, replicas: int | None = None, dtype=None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.replicas = replicas
        self.dtype = resolve_dtype(dtype)
        fan_in = 1
        for n in self.in_shape:
            fan_in *= n
        lead = () if replicas is None else (replicas,)
        self.kernel = nn.Parameter(torch.empty(lead + self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(lead + self.out_shape))
        lecun_normal_(self.kernel, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        kernel, bias = self.kernel, self.bias
        if self.dtype is not None:
            x, kernel, bias = x.to(self.dtype), kernel.to(self.dtype), bias.to(self.dtype)
        if self.replicas is not None:
            r = self.replicas
            flat = x.reshape(r, -1, math.prod(self.in_shape)) @ \
                kernel.reshape(r, -1, math.prod(self.out_shape))
            return (flat + bias.reshape(r, 1, -1)).reshape(*lead, *self.out_shape)
        flat = x.reshape(*lead, -1) @ kernel.reshape(-1, bias.numel())
        return (flat + bias.reshape(-1)).reshape(*lead, *self.out_shape)


class ReplicaLayerNorm(nn.Module):
    """LayerNorm (eps 1e-6) with its own ``weight`` and ``bias`` [R, dim]
    per replica, over inputs [R, ..., dim]."""

    def __init__(self, replicas: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(replicas, dim))
        self.bias = nn.Parameter(torch.zeros(replicas, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        normed = F.layer_norm(x, x.shape[-1:], eps=LAYER_NORM_EPS)
        return normed * self.weight.reshape(shape) + self.bias.reshape(shape)


def layer_norm(dim: int, replicas: int | None = None) -> nn.Module:
    """Flax's LayerNorm over the last axis, one per replica with ``replicas``."""
    if replicas is None:
        return nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
    return ReplicaLayerNorm(replicas, dim)


class MultiHeadSelfAttention(nn.Module):
    """QKV/out projections around the dense or the flash attention core, in
    ``dtype``; the core takes q, k, v of that type."""

    def __init__(self, in_dim: int, num_heads: int, qkv_features: int, out_features: int,
                 use_flash: bool | None = None, flash_min_seq: int = 1024,
                 fuse_qkv: bool = False, generator: Generators = None,
                 replicas: int | None = None, dtype=None):
        super().__init__()
        head_dim = qkv_features // num_heads
        self.use_flash = use_flash
        self.flash_min_seq = flash_min_seq
        self.fuse_qkv = fuse_qkv
        self.replicas = replicas
        if fuse_qkv:
            self.qkv = DenseGeneral((in_dim,), (3, num_heads, head_dim), generator, replicas,
                                    dtype)
        else:
            self.query = DenseGeneral((in_dim,), (num_heads, head_dim), generator, replicas, dtype)
            self.key = DenseGeneral((in_dim,), (num_heads, head_dim), generator, replicas, dtype)
            self.value = DenseGeneral((in_dim,), (num_heads, head_dim), generator, replicas, dtype)
        self.out = DenseGeneral((num_heads, head_dim), (out_features,), generator, replicas,
                                dtype)

    def flash(self, x: torch.Tensor) -> bool:
        """The dispatch rule: the flag if set, else large sets on the GPU."""
        if self.use_flash is not None:
            return self.use_flash
        return x.shape[-2] >= self.flash_min_seq and x.is_cuda

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, in] -> [B, S, out_features], or [R, B, S, in] -> [R, B, S,
        out_features] with replicas (the core sees [R * B, S, H, D] views)."""
        if self.fuse_qkv:
            qkv = self.qkv(x)                                    # [B, S, 3, H, D]
            q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        else:
            q, k, v = self.query(x), self.key(x), self.value(x)  # [B, S, H, D]
        attend = flash_self_attention if self.flash(x) else dense_self_attention
        if self.replicas is None:
            return self.out(attend(q, k, v).to(q.dtype))
        out = attend(q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1))
        return self.out(out.to(q.dtype).unflatten(0, q.shape[:2]))


class SetAttentionBlock(nn.Module):
    """Post-LN self-attention block: x + MHA(x) -> LN -> (+FF) -> LN, the
    attention and the feed-forward MLP in ``compute_dtype``, the residual
    sums and LayerNorms in x's type (float32)."""

    def __init__(self, num_heads: int = 12, key_dim: int = 128, ff_hidden: Sequence[int] = (128,),
                 model_dim: int = 32, ff_activation: str | Callable | None = "relu",
                 use_flash: bool | None = None, flash_min_seq: int = 1024,
                 fuse_qkv: bool = False, generator: Generators = None,
                 replicas: int | None = None, compute_dtype=None):
        super().__init__()
        self.attention = MultiHeadSelfAttention(
            model_dim, num_heads, num_heads * key_dim, model_dim, use_flash, flash_min_seq,
            fuse_qkv, generator, replicas, compute_dtype)
        self.norm0 = layer_norm(model_dim, replicas)
        self.ff = MLP(model_dim, ff_hidden, model_dim, ff_activation,
                      output_activation=ff_activation, generator=generator, stack=replicas,
                      dtype=compute_dtype)
        self.norm1 = layer_norm(model_dim, replicas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm0(x + self.attention(x).to(x.dtype))
        return self.norm1(h + self.ff(h).to(h.dtype))


class SetTransformer(nn.Module):
    """Set-attention blocks -> mean pool -> head MLP -> linear output.

    Input [B, S, model_dim], output [B, output_dim]; with ``replicas=R``,
    [R, B, S, model_dim] -> [R, B, output_dim]. ``remat`` recomputes
    each block on the backward pass (``torch.utils.checkpoint``), so a
    block's activations are not kept between the passes. Parameters are
    initialised on the CPU from ``generator`` (or one generator per
    replica) and moved to ``device`` (``None`` means the GPU).
    """

    def __init__(self, num_blocks: int = 6, num_heads: int = 12, key_dim: int = 128,
                 model_dim: int = 32, ff_hidden: Sequence[int] = (128,),
                 head_hidden: Sequence[int] = (256,), output_dim: int = 1,
                 ff_activation: str | Callable | None = "relu",
                 head_activation: str | Callable | None = "leaky_relu",
                 use_flash: bool | None = None, flash_min_seq: int = 1024,
                 fuse_qkv: bool = False, remat: bool = False, compute_dtype=None, *,
                 device=None, generator: Generators = None, replicas: int | None = None):
        super().__init__()
        device = resolve_device(device)
        self.remat = remat
        self.blocks = nn.ModuleList(
            SetAttentionBlock(num_heads, key_dim, ff_hidden, model_dim, ff_activation,
                              use_flash, flash_min_seq, fuse_qkv, generator, replicas,
                              compute_dtype)
            for _ in range(num_blocks))
        # hidden layers in the compute dtype, the logits float32
        self.head = MLP(model_dim, head_hidden, output_dim, head_activation,
                        generator=generator, stack=replicas, dtype=compute_dtype,
                        output_dtype=torch.float32)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.head(x.mean(dim=-2))

