"""Self-attention over sets: the dense version and the flash kernel.

``dense_self_attention`` is the counterpart of
``dib_tpu/parallel/context.py::dense_self_attention``: plain PyTorch, as XLA
computed it outside any Pallas kernel. q is scaled BEFORE the q.k product,
the softmax runs in float32, and bfloat16 scores are used only for bfloat16
inputs (``DIB_ATTN_SCORE_DTYPE``, default bfloat16, selects them).

``flash_self_attention`` replaces ``dib_tpu/ops/pallas_attention.py::
flash_self_attention`` (the Pallas kernel ``_flash_kernel``): blockwise
online-softmax attention that never forms the [S, S] score matrix. On a
CUDA tensor it launches ``csrc/flash_attention.cu``: float32 inputs on the
CUDA cores, bfloat16 inputs on the tensor cores (see the note there for
what bounds each on an H100); on a CPU tensor it takes the plain version
``flash_self_attention_reference``. Its backward is the blocked recompute
of ``_flash_bwd_rule`` (blocked XLA in the JAX package, ``torch.matmul``
here): the logsumexp is recomputed one query block at a time, so no [S, S]
intermediate exists in either direction.

Layout everywhere: q, k, v are [B, S, H, D]; the output is [B, S, H, D]
float32.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from dib_tpu_torch.ops import _build

MAX_HEAD_DIM = 128     # widest head the kernel's shared-memory tiles hold
BLOCK_Q = 256          # query rows per block of the backward recompute
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches made by ``flash_self_attention``, and those of them on
# bfloat16 inputs (the tensor-core kernel); the plain version never counts.
flash_attention_launches = 0
flash_attention_bf16_launches = 0


def _dense_score_dtype() -> torch.dtype:
    """Score dtype of ``dense_self_attention`` for bfloat16 inputs."""
    name = os.environ.get("DIB_ATTN_SCORE_DTYPE", "bfloat16").lower()
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32"):
        return torch.float32
    raise ValueError(f"DIB_ATTN_SCORE_DTYPE={name!r}: use 'float32' or 'bfloat16'")


@functools.cache
def _scale_in(dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(dim) rounded to ``dtype``, as the JAX package multiplies q by a
    weakly typed scale (0.353515625 for dim 8 in bfloat16)."""
    return float(torch.tensor(1.0 / math.sqrt(dim), dtype=dtype))


def dense_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention, [B, S, H, D] -> [B, S, H, D] float32.

    Products of inputs of one type accumulate in float32 (the JAX package's
    ``preferred_element_type``); the scores are then rounded to the score
    dtype, which is float32 unless the inputs are bfloat16.
    """
    scale = _scale_in(q.shape[-1], q.dtype)
    score_dtype = _dense_score_dtype() if q.dtype == torch.bfloat16 else torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float()).to(score_dtype)
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def flash_self_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the flash kernel's arithmetic.

    Scores are the float32 q.k products scaled AFTER the product, as
    ``_flash_kernel`` scales them; the unnormalised probabilities are
    rounded to the input type before the p.v product (a no-op for float32)
    and the sum is divided by the float32 normaliser at the end.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                               # [B, H, S]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc / l.transpose(1, 2)[..., None]


def flash_attention_backward(q, k, v, d_out, block_q: int = BLOCK_Q):
    """Gradients (dq, dk, dv) of flash attention by blocked recompute.

    The counterpart of ``_flash_bwd_rule``: q (pre-scaled), k, v and the
    output's cotangent are folded to [B*H, S, D] float32; each query block
    recomputes its scores and their logsumexp over every key, and adds its
    share to dk and dv. The last block is sliced to the rows that exist, so
    there are no padded query rows to mask.

    One departure from ``_flash_bwd_rule``: each row's ``sum_k p dp`` is
    taken from the recomputed probabilities, not as ``sum(out * d_out)``
    from the forward's output. The two are equal only while ``out = p . v``
    holds exactly, and the forward rounds p to the input type before p . v:
    for bfloat16 inputs near a one-hot row, ``dp - sum(out * d_out)`` is
    then as small as that rounding: the flagship's bf16 step on an H100 lay
    31% of its gradient's norm from the float32 step with the forward's
    output (block 0's dq and dk), 3.8% with the recomputed sums, as on the
    CPU. For float32 inputs the two agree to float32 rounding.
    """
    batch, seq, heads, dim = q.shape
    scale = 1.0 / math.sqrt(dim)

    def fold(x):
        return x.float().movedim(2, 1).reshape(batch * heads, -1, dim)

    qf = fold(q) * scale
    kf, vf, dof = fold(k), fold(v), fold(d_out)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for start in range(0, seq, block_q):
        rows = slice(start, start + block_q)
        qi, doi = qf[:, rows], dof[:, rows]
        s = qi @ kf.transpose(1, 2)                                 # [BH, bq, S]
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        dp = doi @ vf.transpose(1, 2)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[:, rows] = (ds @ kf) * scale
        dk += ds.transpose(1, 2) @ qi
        dv += p.transpose(1, 2) @ doi

    def unfold(x, like):
        return x.reshape(batch, heads, -1, dim).movedim(1, 2).to(like.dtype)

    return unfold(dq, q), unfold(dk, k), unfold(dv, v)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out = flash_self_attention_reference(q, k, v)
        elif q.device.type == "cuda":
            out = _launch(q, k, v)
        else:
            raise ValueError(
                f"flash_self_attention runs on cpu or cuda tensors, not {q.device.type}")
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, d_out):
        return flash_attention_backward(*ctx.saved_tensors, d_out)


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] self-attention without the [S, S] matrix; float32 output.

    Same contract as :func:`dense_self_attention`. A CUDA tensor launches
    the kernel (float32 or bfloat16 inputs of one type, D <= 128, any
    strides with a unit stride along D) or raises; a CPU tensor takes the
    plain version. Differentiable through the blocked recompute.
    """
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one shape [B, S, H, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    return _FlashAttention.apply(q, k, v)


@functools.cache
def _kernel_entry():
    """The C entry point ``flash_attention_launch``, built and typed on first use."""
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v):
    global flash_attention_launches, flash_attention_bf16_launches
    batch, seq, heads, dim = q.shape
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16 inputs of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= dim <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel supports 1 <= D <= {MAX_HEAD_DIM}, got D = {dim}")
    if min(batch, seq, heads) < 1:
        raise ValueError(f"the kernel needs non-empty inputs, got {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the kernel takes inputs with a unit stride along D")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        batch, seq, heads, dim, *strides, 1.0 / math.sqrt(dim),
        _DTYPE_CODES[q.dtype], q.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention_launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_bf16_launches += 1
    return out
