#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dib_tpu_torch``) on one GPU and check it.

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and continued):

  1. print the card's name and power limit; switch TF32 off
  2. build every CUDA kernel from ``dib_tpu_torch/csrc`` (one nvcc per source)
  3. hold each kernel against its plain PyTorch version on the card
  4. serve: the flagship boolean-circuit model at full width behind an
     ``InferenceEngine`` and a ``MicroBatcher``, fed by client threads
  5. the per-channel MI query ``all_features_bounds`` on the validation rows
     (phases 4-5 are the main path; kernel launch counts are read around it),
     checked against the plain path on the same draws
  6. CUDA-event timings of the kernel, its plain version, the MI query and
     ``predict`` at each bucket, beside the kernel's roofline bound
  7. one JSON line listing each ported kernel
  8. the last line: ``{"ok": true, "device": {...}}``

Without a CUDA device it exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
F32_TOL = 2e-5            # kernel vs plain, float32 inputs
BF16_TOL = 2e-2           # kernel vs plain, bfloat16 inputs
SERVE_TOL = 1e-6          # batched vs direct dispatch
BOUNDS_TOL = 1e-4         # nats per feature, kernel path vs plain path
EVAL_BATCH, EVAL_BATCHES = 1024, 8
# H100 SXM published peaks: f32 on the CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def fail(message: str):
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, tol):
    """Max abs/rel error over output tuples; fails beyond atol = rtol = tol."""
    worst_abs = worst_rel = 0.0
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        worst_abs = max(worst_abs, diff.max().item())
        worst_rel = max(worst_rel, (diff / w.float().abs().clamp_min(1e-30)).max().item())
        if not torch.isfinite(g).all() or not bool((diff <= tol + tol * w.float().abs()).all()):
            fail(f"{name}: kernel disagrees with the plain version "
                 f"(max abs {worst_abs:.3e}, max rel {worst_rel:.3e}, tol {tol})")
    print(f"check {name}: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} tol={tol}")
    return worst_abs


def channel_inputs(gen, g, n, d, dtype=torch.float32, m=None, probe=False):
    """Random channel parameters; u drawn from its own row's Gaussian (the
    diagonal-dominant regime of the sandwich bounds) unless ``probe``."""
    m = n if m is None else m
    mus = 2.0 * torch.randn(g, m, d, generator=gen, device="cuda")
    lv = 0.7 * torch.randn(g, m, d, generator=gen, device="cuda") - 1.0
    if probe:
        u = 2.0 * torch.randn(g, n, d, generator=gen, device="cuda")
    else:
        u = mus + torch.randn(g, n, d, generator=gen, device="cuda") * torch.exp(0.5 * lv)
    return u.to(dtype), mus.to(dtype), lv.to(dtype)


def time_ms(fn, runs: int = 20, inner: int = 1, warmup: int = 3) -> float:
    """Median over ``runs`` of CUDA-event time per call (``inner`` calls per run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def profile_breakdown(fn, top: int = 6) -> str:
    """Device time of one warm call of ``fn`` by kernel, from torch.profiler:
    the device's busy share of the call's wall time and the largest kernels.
    "not measured" when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return "not measured (no device activity recorded)"
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    parts = [f"{e.key[:60]} {e.self_device_time_total:.1f} us x{e.count}" for e in kernels[:top]]
    return (f"wall {wall_us:.1f} us (profiled), device busy {busy_us:.1f} us "
            f"({busy_us / wall_us:.1%}); " + "; ".join(parts))


def row_stats_bound_ms(g, n, m, d, itemsize, diagonal=True):
    """Least time for the row statistics on an H100: the larger of the f32
    operations over the f32 peak and the bytes (inputs once, outputs once)
    over HBM bandwidth. Per (row, column) pair: 4 per channel dim
    (difference, scale, square-accumulate as an FMA) plus the normaliser
    (2) and, per reduction, max, subtract, exp and add (4)."""
    reductions = 2 if diagonal else 1
    ops = g * n * m * (4 * d + 2 + 4 * reductions)
    nbytes = (g * n * d + 2 * g * m * d) * itemsize + (3 if diagonal else 1) * g * n * 4
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from dib_tpu_torch.data import get_dataset
    from dib_tpu_torch.models import DistributedIBModel
    from dib_tpu_torch.ops import _build, density
    from dib_tpu_torch.ops.gaussian import reparameterize
    from dib_tpu_torch.ops.info_bounds import sandwich_from_row_stats
    from dib_tpu_torch.serve import InferenceEngine, MicroBatcher
    from dib_tpu_torch.train.hooks import all_features_bounds

    # ---- 1. card -------------------------------------------------------
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build(["mi_row_stats"])
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(paths)} kernel source(s)")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        res = subprocess.run([cuobjdump, "-res-usage", str(paths["mi_row_stats"])],
                             capture_output=True, text=True, timeout=60)
        for line in res.stdout.splitlines():
            if "REG" in line or "Function" in line:
                print("  " + line.strip())

    # ---- 3. kernels vs plain versions on the card ----------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("square G=10 N=1024 d=32 f32", channel_inputs(gen, 10, 1024, 32), True, F32_TOL),
        ("ragged G=3 N=1000 d=37 f32", channel_inputs(gen, 3, 1000, 37), True, F32_TOL),
        ("single row G=2 N=1 d=32 f32", channel_inputs(gen, 2, 1, 32), True, F32_TOL),
        ("square G=10 N=1024 d=32 bf16",
         channel_inputs(gen, 10, 1024, 32, torch.bfloat16), True, BF16_TOL),
        ("probe M=10000 N=512 d=32 f32",
         channel_inputs(gen, 1, 10000, 32, m=512, probe=True), False, F32_TOL),
    ]
    for name, (u, mus, lv), diagonal, tol in cases:
        got = density.mi_row_stats(u, mus, lv, diagonal=diagonal)
        torch.cuda.synchronize()
        want = density.mi_row_stats_reference(u, mus, lv, diagonal=diagonal)
        compare(f"mi_row_stats {name}", got, want, tol)
    single = density.mi_row_stats(*cases[2][1])
    if not bool((single[2] == density.NEG_INF).all()):
        fail("N=1 off-diagonal row is not the large-finite mask value")

    # ---- 4-5. main path: serve, then the MI query ----------------------
    bundle = get_dataset("boolean_circuit")
    model = DistributedIBModel(
        bundle.feature_dimensionalities, output_dim=bundle.output_dimensionality,
        device="cuda", generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: DistributedIBModel F={model.num_features} params={n_params}")
    engine = InferenceEngine(model, device="cuda")
    rows_np = np.asarray(bundle.x_valid, np.float32)

    density.mi_row_stats_launches = 0
    batcher = MicroBatcher(engine, max_batch=32, max_wait_ms=2.0)
    rng = np.random.default_rng(SEED)
    requests = [rows_np[rng.integers(0, len(rows_np), size=int(rng.integers(1, 9)))]
                for _ in range(64)]
    results: dict[int, dict] = {}
    errors: list[Exception] = []

    def client(worker: int, n_workers: int = 4):
        try:
            futures = [(i, batcher.submit(requests[i]))
                       for i in range(worker, len(requests), n_workers)]
            for i, fut in futures:
                results[i] = fut.result(timeout=120)
        except Exception as exc:     # reported by the main thread below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(w,)) for w in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    serve_s = time.perf_counter() - t0
    batcher.close()
    if errors or any(t.is_alive() for t in threads) or len(results) != len(requests):
        fail(f"serving: {len(results)}/{len(requests)} results, errors {errors[:3]}")

    mi_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    lower, upper = all_features_bounds(model, rows_np, EVAL_BATCH, EVAL_BATCHES,
                                       generator=mi_gen)
    torch.cuda.synchronize()
    launches = {"mi_row_stats": density.mi_row_stats_launches}
    print(f"main path launches: {json.dumps(launches)}")
    if launches["mi_row_stats"] < EVAL_BATCHES:
        fail(f"mi_row_stats launched {launches['mi_row_stats']} times in the MI "
             f"query, expected one per eval batch ({EVAL_BATCHES})")

    # serving results: batched == direct dispatch, finite, right shapes
    worst = 0.0
    for i, rows in enumerate(requests):
        direct = engine.predict(rows)
        got = results[i]
        for key, width in (("prediction", bundle.output_dimensionality),
                           ("kl_per_feature", model.num_features)):
            if got[key].shape != (len(rows), width) or not np.isfinite(got[key]).all():
                fail(f"serving: request {i} {key} shape {got[key].shape} or non-finite")
            err = np.abs(got[key] - direct[key])
            worst = max(worst, float(err.max()))
            if not (err <= SERVE_TOL + SERVE_TOL * np.abs(direct[key])).all():
                fail(f"serving: request {i} {key} batched != direct (max {err.max():.3e})")
    print(f"serve: {len(requests)} requests from 4 threads in {serve_s:.3f} s; "
          f"batched vs direct max_abs_err={worst:.3e} tol={SERVE_TOL}")

    # MI query: replay the same draws, hold the kernel path to the plain path
    rows = torch.from_numpy(rows_np).cuda()
    replay = torch.Generator(device="cuda").manual_seed(SEED + 1)
    idx, us, stats_in = [], [], []
    with torch.inference_mode():
        for _ in range(EVAL_BATCHES):
            b_idx = torch.randint(0, len(rows), (EVAL_BATCH,), generator=replay, device="cuda")
            mus, lv = model.encode(rows[b_idx])
            u = reparameterize(mus, lv, replay)
            idx.append(b_idx)
            us.append(u)
            stats_in.append((u, mus, lv))
        idx, us = torch.stack(idx), torch.stack(us)
        k_lower, k_upper = all_features_bounds(model, rows, EVAL_BATCH, EVAL_BATCHES,
                                               idx=idx, u=us)
        plain = [sandwich_from_row_stats(*density.mi_row_stats_reference(*s)) for s in stats_in]
        p_lower = torch.stack([p[0] for p in plain]).mean(0)
        p_upper = torch.stack([p[1] for p in plain]).mean(0)
    replay_err = max((k_lower - lower).abs().max().item(), (k_upper - upper).abs().max().item())
    if replay_err > 1e-5:
        fail(f"MI query: replaying the generator's draws moved the bounds by {replay_err:.3e}")
    mi_err = max((k_lower - p_lower).abs().max().item(), (k_upper - p_upper).abs().max().item())
    if mi_err > BOUNDS_TOL:
        fail(f"MI query: kernel path vs plain path differ by {mi_err:.3e} nats")
    if lower.shape != (model.num_features,) or not torch.isfinite(torch.cat([lower, upper])).all():
        fail("MI query: bounds of the wrong shape or non-finite")
    if not bool((lower <= upper + BOUNDS_TOL).all()):
        fail("MI query: a lower bound exceeds its upper bound")
    if not bool((lower <= math.log(EVAL_BATCH) + BOUNDS_TOL).all()):
        fail("MI query: an InfoNCE lower bound exceeds log(batch)")
    print(f"MI query: F={model.num_features} batch={EVAL_BATCH}x{EVAL_BATCHES} "
          f"lower(nats)={[round(v, 5) for v in lower.tolist()]} "
          f"upper(nats)={[round(v, 5) for v in upper.tolist()]} "
          f"kernel vs plain max_abs_err={mi_err:.3e} tol={BOUNDS_TOL}")

    # ---- 6. timings ----------------------------------------------------
    u, mus, lv = stats_in[-1]
    u, mus, lv = u.contiguous(), mus.contiguous(), lv.contiguous()
    g, n, d = u.shape
    k_err = compare("mi_row_stats main-path inputs",
                    density.mi_row_stats(u, mus, lv),
                    density.mi_row_stats_reference(u, mus, lv), F32_TOL)
    kernel_ms = time_ms(lambda: density.mi_row_stats(u, mus, lv), inner=10)
    plain_ms = time_ms(lambda: density.mi_row_stats_reference(u, mus, lv))
    bound_ms, bound_by = row_stats_bound_ms(g, n, n, d, u.element_size())
    print(f"timing [{card}] mi_row_stats G={g} N={n} d={d} f32: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"roofline share {bound_ms / kernel_ms:.1%}")
    pu, pm, pl = cases[4][1]
    probe_ms = time_ms(lambda: density.mi_row_stats(pu, pm, pl, diagonal=False), inner=10)
    probe_plain_ms = time_ms(lambda: density.mi_row_stats_reference(pu, pm, pl, diagonal=False))
    probe_bound, probe_by = row_stats_bound_ms(1, pu.shape[1], pm.shape[1], pu.shape[2], 4,
                                               diagonal=False)
    print(f"timing [{card}] mi_row_stats probe M={pu.shape[1]} N={pm.shape[1]} d={pu.shape[2]} "
          f"f32: kernel {probe_ms:.4f} ms, plain {probe_plain_ms:.4f} ms, "
          f"bound {probe_bound:.4f} ms ({probe_by})")
    bounds_ms = time_ms(lambda: all_features_bounds(
        model, rows, EVAL_BATCH, EVAL_BATCHES, generator=mi_gen))
    print(f"timing [{card}] all_features_bounds F={model.num_features} "
          f"batch={EVAL_BATCH}x{EVAL_BATCHES}: {bounds_ms:.4f} ms")
    breakdown = profile_breakdown(lambda: all_features_bounds(
        model, rows, EVAL_BATCH, EVAL_BATCHES, generator=mi_gen))
    print(f"profile [{card}] all_features_bounds: {breakdown}")
    predict_ms = {}
    for bucket in engine.buckets:
        x = rows_np[:bucket]
        predict_ms[bucket] = time_ms(lambda: engine.predict(x))
    print(f"timing [{card}] predict per bucket (ms): {json.dumps(predict_ms)}")
    x_top = rows_np[:engine.max_bucket]
    print(f"profile [{card}] predict bucket {engine.max_bucket}: "
          f"{profile_breakdown(lambda: engine.predict(x_top))}")

    # ---- 7-8. summary lines --------------------------------------------
    kernels = [{
        "name": "mi_row_stats",
        "route": "cuda",
        "source": "dib_tpu_torch/csrc/mi_row_stats.cu",
        "replaces": "dib_tpu/ops/pallas_density.py:189",
        "launches": launches["mi_row_stats"],
        "max_abs_err": k_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
