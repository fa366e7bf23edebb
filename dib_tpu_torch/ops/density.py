"""The Gaussian log-density kernels and their plain versions: the one-pass
MI-sandwich row statistics and the full log-density matrix.

The sandwich bounds consume only three per-row reductions of the [N, M]
log-density matrix ``log p(u_i | x_j)``: the diagonal entry, the logsumexp
over the full row and the logsumexp over the off-diagonal entries (the LOO
bound excludes the diagonal but still divides by B). The kernel in
``csrc/mi_row_stats.cu`` computes all three in one pass without ever forming
the matrix.

Replaces: ``dib_tpu/ops/pallas_density.py::_row_stats_kernel`` (through
``mi_row_stats_pallas``), both its square mode (``diagonal=True``) and its
probe mode (``diagonal=False``, an asymmetric [M probes, N data] input where
only the full-row reduction exists).

Bound on an H100: operations, not bytes. Each (row, column) pair costs 3d
FP32 instructions on the CUDA cores (direct difference, scale,
square-accumulate; tensor cores cannot form a direct difference) plus about
7 for its online logsumexp, against O((N + M) d) bytes per group. The design
is an SGEMM-style micro-kernel: a staging pass writes the inputs as f32,
channel-major and padded, with each column's exp(-lv/2) and log-variance
sum computed once; 128 x 128 block tiles of 8 x 8 rows x columns per thread
read distinct vectors from shared memory; one online reduction runs over
the off-diagonal and the diagonal is merged in at the end; and when the
grid would underfill the card the columns are split over blocks
(:func:`column_splits`) and a merge pass combines them. See the source note
in the ``.cu`` file.

The second kernel, ``csrc/log_density_mat.cu`` behind
:func:`log_density_matrix`, writes the whole [N, M] matrix. It replaces
``dib_tpu/ops/pallas_density.py::_density_kernel`` (through
``gaussian_log_density_mat_pallas``); the kernel microbench
(``dib_tpu_torch.scripts.bench_kernels``) is the path that runs it. It is
bound by the FP32 issue rate (3d instructions per entry), with the output
written once under that. It is the same micro-kernel without the
reduction: a staging pass writes u, mu and exp(-lv/2) channel-major and
padded, with each column's normaliser, into a workspace once per call;
one block per 128 x 128 tile, 8 x 8 entries per thread, takes any d
through a cp.async ring, and each row leaves as coalesced float4
streaming stores. The grid is one-dimensional, so N has no limit.

Both wrappers take the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from dib_tpu_torch.ops import _build
from dib_tpu_torch.ops.gaussian import gaussian_log_density_mat

NEG_INF = -1e30   # large-finite mask value: inf - inf would give NaN
MAX_DIM = 64      # widest channel the kernel's staging pass holds
MAX_GROUPS = 65535   # most groups one launch takes (a grid axis of its kernels)
# Waves of blocks below which the kernel's columns are split (on an H100 a
# target of 8 waves ran faster than one of 2 at G = 10 and 50; PERF.md).
WAVES = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches made by ``mi_row_stats`` and ``log_density_matrix``; the
# plain versions never count.
mi_row_stats_launches = 0
log_density_mat_launches = 0


def mi_row_stats_reference(u: torch.Tensor, mus: torch.Tensor, logvars: torch.Tensor,
                           diagonal: bool = True):
    """Plain PyTorch version of the kernel: forms the matrix and reduces it.

    Same contract as :func:`mi_row_stats`; always computes in float32.
    """
    u, mus, logvars = u.float(), mus.float(), logvars.float()
    log_p = gaussian_log_density_mat(u, mus, logvars)             # [..., N, M]
    full = torch.logsumexp(log_p, dim=-1)
    if not diagonal:
        return full, full, full
    n = log_p.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=log_p.device)
    diag = torch.diagonal(log_p, dim1=-2, dim2=-1)
    off = torch.logsumexp(log_p.masked_fill(eye, NEG_INF), dim=-1)
    return diag, full, off


def mi_row_stats(u: torch.Tensor, mus: torch.Tensor, logvars: torch.Tensor,
                 diagonal: bool = True):
    """Per-row sandwich statistics ``(diag, lse_full, lse_off)``, float32.

    ``u`` is [N, d] or [G, N, d]; ``mus``/``logvars`` [M, d] or [G, M, d]
    with the same leading group axis G (the features), so one launch covers
    every group. Each output is [N] or [G, N]:

      - ``diag[i]``     = log p(u_i | x_i)          (``diagonal=True``, N == M)
      - ``lse_full[i]`` = logsumexp_j log p(u_i | x_j)
      - ``lse_off[i]``  = logsumexp_{j != i} log p(u_i | x_j)

    With ``diagonal=False`` only the full-row reduction is computed and it is
    returned three times. Inputs of float32 or bfloat16 accumulate in
    float32. Masked entries are the large-finite ``NEG_INF``, so a row with
    every entry masked (the off-diagonal of N = 1) comes back as ``NEG_INF``.
    """
    grouped = u.dim() == 3
    if not grouped:
        u, mus, logvars = u[None], mus[None], logvars[None]
    if u.dim() != 3 or mus.dim() != 3 or mus.shape != logvars.shape:
        raise ValueError(f"expected u [G,N,d], mus/logvars [G,M,d]; got "
                         f"{tuple(u.shape)}, {tuple(mus.shape)}, {tuple(logvars.shape)}")
    if u.shape[0] != mus.shape[0] or u.shape[2] != mus.shape[2]:
        raise ValueError(f"group or channel axes differ: {tuple(u.shape)} vs {tuple(mus.shape)}")
    if diagonal and u.shape[1] != mus.shape[1]:
        raise ValueError(f"square mode needs N == M, got {u.shape[1]} and {mus.shape[1]}")
    if not (u.device == mus.device == logvars.device):
        raise ValueError("u, mus and logvars must be on one device")
    if u.device.type == "cpu":
        out = mi_row_stats_reference(u, mus, logvars, diagonal)
    elif u.device.type == "cuda":
        out = _launch(u, mus, logvars, diagonal)
    else:
        raise ValueError(f"mi_row_stats runs on cpu or cuda tensors, not {u.device.type}")
    return out if grouped else tuple(o[0] for o in out)


def column_splits(g: int, n: int, m: int, sm_count: int, tile: int = 128,
                  blocks_per_sm: int = 2) -> int:
    """How many ranges the kernel splits the columns into, for G groups of
    N rows against M columns on a card of ``sm_count`` SMs.

    One block reduces ``tile`` rows of a group over its range of
    ``tile``-column tiles, in order, so the last wave of blocks sets the
    tail. When the G * ceil(N / tile) row blocks fill at least ``WAVES``
    waves of the card (``blocks_per_sm`` blocks per SM) the columns stay
    whole; otherwise they are split just far enough to reach that, never
    into more ranges than there are tiles, and evened so that every range
    holds the same number of tiles (the last may hold fewer). A merge pass
    then combines the ranges. The card path passes the built kernel's own
    tile and blocks per SM (:func:`kernel_column_splits`); the defaults are
    their values in ``csrc/mi_row_stats.cu``.
    """
    row_blocks = g * math.ceil(n / tile)
    tiles = math.ceil(m / tile)
    target = WAVES * blocks_per_sm * sm_count
    if row_blocks >= target:
        return 1
    splits = min(tiles, math.ceil(target / row_blocks))
    return math.ceil(tiles / math.ceil(tiles / splits))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_column_splits(g: int, n: int, m: int, device_index: int) -> int:
    """:func:`column_splits` on the card ``device_index`` with the built
    kernel's tile and blocks per SM: the split a kernel call takes."""
    kernel = _kernel_entry()
    return column_splits(g, n, m, _sm_count(device_index), kernel.tile, kernel.blocks_per_sm)


class _Kernel(NamedTuple):
    launch: Callable[..., int]             # mi_row_stats_launch
    workspace_floats: Callable[..., int]   # mi_row_stats_workspace_floats
    tile: int
    blocks_per_sm: int


@functools.cache
def _kernel_entry() -> _Kernel:
    """The kernel's C entry points and geometry, built and typed on first use."""
    lib = _build.load("mi_row_stats")
    fn = lib.mi_row_stats_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.mi_row_stats_workspace_floats
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return _Kernel(fn, size, lib.mi_row_stats_tile(), lib.mi_row_stats_blocks_per_sm())


def _launch(u, mus, logvars, diagonal: bool):
    global mi_row_stats_launches
    g, n, d = u.shape
    m = mus.shape[1]
    if not (u.dtype == mus.dtype == logvars.dtype) or u.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16 inputs of one type, got "
                        f"{u.dtype}, {mus.dtype}, {logvars.dtype}")
    if not (u.is_contiguous() and mus.is_contiguous() and logvars.is_contiguous()):
        raise ValueError("the kernel takes contiguous inputs")
    if d > MAX_DIM:
        raise ValueError(f"the kernel supports d <= {MAX_DIM}, got d = {d}")
    if not 1 <= g <= MAX_GROUPS or n == 0 or m == 0:
        raise ValueError(f"the kernel needs 1 <= G <= {MAX_GROUPS} and non-empty rows, got "
                         f"G={g}, N={n}, M={m}")
    kernel = _kernel_entry()
    splits = kernel_column_splits(g, n, m, u.device.index)
    workspace = torch.empty(kernel.workspace_floats(g, n, m, d, splits), dtype=torch.float32,
                            device=u.device)
    full = torch.empty((g, n), dtype=torch.float32, device=u.device)
    diag = torch.empty_like(full) if diagonal else None
    off = torch.empty_like(full) if diagonal else None
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = kernel.launch(
        u.data_ptr(), mus.data_ptr(), logvars.data_ptr(),
        diag.data_ptr() if diagonal else None, full.data_ptr(),
        off.data_ptr() if diagonal else None, workspace.data_ptr(), workspace.numel(),
        g, n, m, d, splits, _DTYPE_CODES[u.dtype], int(diagonal), u.device.index, stream)
    if err != 0:
        raise RuntimeError(f"mi_row_stats kernel launch failed with CUDA error {err}")
    mi_row_stats_launches += 1
    return (diag, full, off) if diagonal else (full, full, full)


def log_density_matrix(u: torch.Tensor, mus: torch.Tensor, logvars: torch.Tensor) -> torch.Tensor:
    """The [N, M] matrix ``log p(u_i | x_j)`` of diagonal Gaussians.

    ``u`` is [N, d], ``mus``/``logvars`` [M, d]. Same contract as
    :func:`~dib_tpu_torch.ops.gaussian.gaussian_log_density_mat`, its plain
    version, which CPU tensors take. On a CUDA tensor the kernel takes
    contiguous float32 inputs and writes a float32 matrix.
    """
    if u.dim() != 2 or mus.dim() != 2 or mus.shape != logvars.shape:
        raise ValueError(f"expected u [N,d], mus/logvars [M,d]; got "
                         f"{tuple(u.shape)}, {tuple(mus.shape)}, {tuple(logvars.shape)}")
    if u.shape[1] != mus.shape[1]:
        raise ValueError(f"channel axes differ: {tuple(u.shape)} vs {tuple(mus.shape)}")
    if not (u.device == mus.device == logvars.device):
        raise ValueError("u, mus and logvars must be on one device")
    if u.device.type == "cpu":
        return gaussian_log_density_mat(u, mus, logvars)
    if u.device.type == "cuda":
        return _launch_density(u, mus, logvars)
    raise ValueError(f"log_density_matrix runs on cpu or cuda tensors, not {u.device.type}")


class _DensityKernel(NamedTuple):
    launch: Callable[..., int]             # log_density_mat_launch
    workspace_floats: Callable[..., int]   # log_density_mat_workspace_floats
    tile: int


@functools.cache
def _density_entry() -> _DensityKernel:
    """The density kernel's C entry points and tile, built and typed on first use."""
    lib = _build.load("log_density_mat")
    fn = lib.log_density_mat_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    size = lib.log_density_mat_workspace_floats
    size.argtypes = [ctypes.c_longlong] * 3
    size.restype = ctypes.c_longlong
    return _DensityKernel(fn, size, lib.log_density_mat_tile())


def log_density_mat_tile() -> int:
    """The built density kernel's output tile (rows and columns)."""
    return _density_entry().tile


@functools.lru_cache(maxsize=64)
def _density_workspace_floats(n: int, m: int, d: int) -> int:
    return _density_entry().workspace_floats(n, m, d)


def _launch_density(u, mus, logvars):
    global log_density_mat_launches
    n, d = u.shape
    m = mus.shape[0]
    if not (u.dtype == mus.dtype == logvars.dtype == torch.float32):
        raise TypeError(f"the kernel takes float32 inputs, got "
                        f"{u.dtype}, {mus.dtype}, {logvars.dtype}")
    if not (u.is_contiguous() and mus.is_contiguous() and logvars.is_contiguous()):
        raise ValueError("the kernel takes contiguous inputs")
    if n == 0 or m == 0 or d == 0:
        raise ValueError(f"the kernel needs non-empty N, M and d, got N={n}, M={m}, d={d}")
    workspace = u.new_empty(_density_workspace_floats(n, m, d))   # float32, on u's card
    out = u.new_empty((n, m))
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _density_entry().launch(u.data_ptr(), mus.data_ptr(), logvars.data_ptr(),
                                  out.data_ptr(), workspace.data_ptr(), workspace.numel(), n, m,
                                  d, u.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"log_density_mat kernel launch failed with CUDA error {err}")
    log_density_mat_launches += 1
    return out
