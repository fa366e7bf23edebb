"""Shape-swept microbench of the MI-sandwich density kernels
(counterpart of ``scripts/bench_kernels.py``).

Compares, per shape, the implementations behind the sandwich bounds:

  - ``plain_full``    form the [N, M] log-density matrix in PyTorch, reduce it
  - ``plain_blocked`` ``mi_row_stats_blocked``: row blocks of 128, keeping
                      only the three per-row reductions
  - ``cuda_mat``      the log-density matrix kernel (``log_density_matrix``),
                      reductions in PyTorch
  - ``fused``         the one-pass row-statistics kernel (``mi_row_stats``),
                      no matrix anywhere

over square [B, B] shapes (diagonal, full and off-diagonal reductions) and
asymmetric [M, N] probe shapes (full reduction only), including sizes that
are not multiples of the kernels' tiles. Every arm of every row is held to
``plain_full``; the script exits nonzero if any row fails.

It runs on the GPU unless ``--device cpu`` is given; on the CPU the kernel
arms take their plain versions (each wrapper does so for CPU tensors), so
the record then checks the harness, not the kernels. On the GPU each arm is
timed with CUDA events after a warmup, best of ``--reps``. Emits one JSON
line with the JAX script's schema (``metric``, ``rows[].variants[].seconds``,
``parity``, ``all_parity_ok``, ``device_kind``) plus the card's
``name, power.limit``.

    python -m dib_tpu_torch.scripts.bench_kernels [--device cpu] [--reps N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from dib_tpu_torch.device import card_line, resolve_device
from dib_tpu_torch.ops.density import (NEG_INF, log_density_mat_tile, log_density_matrix,
                                       mi_row_stats)
from dib_tpu_torch.ops.gaussian import gaussian_log_density_mat
from dib_tpu_torch.ops.info_bounds import mi_row_stats_blocked

METRIC = "mi_kernel_bench"
PARITY_TOL = 2e-4    # rtol = atol, as the JAX script holds its arms

# (kind, rows, cols, d): rows == cols for 'square'; ragged sizes exercise
# the bounds checks
CPU_SHAPES = (
    ("square", 128, 128, 8),
    ("square", 192, 192, 8),     # not a multiple of 128
    ("square", 256, 256, 16),
    ("probe", 96, 200, 8),       # ragged both axes
)
TPU_SHAPES = (
    ("square", 512, 512, 16),
    ("square", 1024, 1024, 32),
    ("square", 1000, 1000, 32),  # ragged
    ("square", 4096, 4096, 32),
    ("probe", 1000, 4096, 32),
)
# the flagship's probe maps: a 100 x 100 grid against a 512-particle bank
GPU_SHAPES = TPU_SHAPES + (("probe", 10_000, 512, 32),)


def _reduce_square(log_p):
    n = log_p.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=log_p.device)
    return (torch.diagonal(log_p), torch.logsumexp(log_p, dim=1),
            torch.logsumexp(log_p.masked_fill(eye, NEG_INF), dim=1))


def make_variants(kind: str) -> dict:
    """{name: (u, mus, logvars) -> tuple of outputs} for one shape kind."""
    if kind == "square":
        return {
            "plain_full": lambda u, m, lv: _reduce_square(gaussian_log_density_mat(u, m, lv)),
            "plain_blocked": lambda u, m, lv: mi_row_stats_blocked(u, m, lv, row_block=128),
            "cuda_mat": lambda u, m, lv: _reduce_square(log_density_matrix(u, m, lv)),
            "fused": lambda u, m, lv: mi_row_stats(u, m, lv),
        }
    return {
        "plain_full": lambda u, m, lv: (torch.logsumexp(gaussian_log_density_mat(u, m, lv), 1),),
        "cuda_mat": lambda u, m, lv: (torch.logsumexp(log_density_matrix(u, m, lv), 1),),
        "fused": lambda u, m, lv: mi_row_stats(u, m, lv, diagonal=False)[1:2],
    }


def time_variant(fn, args, reps: int, device: torch.device) -> float:
    """Best-of-``reps`` seconds per call after one warmup call: CUDA events
    on the GPU, the host clock on the CPU."""
    fn(*args)
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best


def bench_shape(kind: str, rows: int, cols: int, d: int, reps: int, device: torch.device,
                rng: np.random.Generator, tile: int | None) -> dict:
    """One row of the record; ``tile`` is the density kernel's output tile,
    ``None`` where no kernel runs (the row's ``tile_divisible`` is then null)."""
    def tensor(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    u = tensor(rng.normal(scale=2.0, size=(rows, d)))
    mus = tensor(rng.normal(scale=2.0, size=(cols, d)))
    lvs = tensor(rng.normal(scale=0.7, size=(cols, d)) - 1.0)
    variants = make_variants(kind)
    seconds = {name: time_variant(fn, (u, mus, lvs), reps, device)
               for name, fn in variants.items()}
    want = variants["plain_full"](u, mus, lvs)
    errors, ok = {}, True
    for name, fn in variants.items():
        got = fn(u, mus, lvs)
        errors[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = ok and all(bool(torch.isfinite(g).all()) and torch.allclose(
            g, w, rtol=PARITY_TOL, atol=PARITY_TOL) for g, w in zip(got, want))
    row = {
        "kind": kind, "rows": rows, "cols": cols, "d": d,
        "tile_divisible": None if tile is None else rows % tile == 0 and cols % tile == 0,
        "variants": {name: {"seconds": s} for name, s in seconds.items()},
        "parity": {"max_abs_err": max(errors.values()), "per_variant": errors,
                   "tol": PARITY_TOL, "ok": ok},
    }
    if seconds["fused"]:
        row["speedup_fused_vs_plain_full"] = seconds["plain_full"] / seconds["fused"]
    return row


def run(device=None, reps: int = 3) -> dict:
    """The record of one sweep on ``device`` (``None`` means the GPU):
    ``GPU_SHAPES`` on the GPU, ``CPU_SHAPES`` on the CPU."""
    device = resolve_device(device)
    on_gpu = device.type == "cuda"
    shapes = GPU_SHAPES if on_gpu else CPU_SHAPES
    rng = np.random.default_rng(0)
    tile = log_density_mat_tile() if on_gpu else None
    rows = [bench_shape(kind, r, c, d, reps, device, rng, tile) for kind, r, c, d in shapes]
    headline = next((row.get("speedup_fused_vs_plain_full")
                     for row in reversed(rows) if row["kind"] == "square"), None)
    return {
        "metric": METRIC,
        "value": headline,
        "unit": "x_speedup",
        "detail": ("fused one-pass kernel vs materialize-and-reduce PyTorch at the largest "
                   "square shape" if on_gpu else
                   "CPU run: the kernel arms took their plain PyTorch versions, so this "
                   "checks the harness and parity, not the kernels or their speed"),
        "device_kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
        "device_platform": "gpu" if on_gpu else "cpu",
        "card": card_line() if on_gpu else None,
        "reps": reps,
        "rows": rows,
        "all_parity_ok": all(row["parity"]["ok"] for row in rows),
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="MI-sandwich density kernel microbench.")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run the plain versions on the CPU; default: the GPU")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=None, help="Also write the JSON record to this path.")
    args = parser.parse_args(argv)
    record = run(args.device, args.reps)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if record["all_parity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
