#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dib_tpu_torch``) on one GPU and check it.

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and continued):

  1. print the card's name and power limit, the device count, scipy's
     version and whether ``tensorstore`` imports; switch TF32 off
  2. build every CUDA kernel from ``dib_tpu_torch/csrc`` (one nvcc per
     source, all started together); print each kernel's registers, and
     fail unless the density kernels show no stack and no spills
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it (the sweep's too: flash at B = 8 x 32
     and 8 x 1024, in float32 and in bfloat16), and the flash kernel's
     gradients (at B = 8 x 32 in both types too); for
     bfloat16 inputs the flash kernel is the tensor-core one, whose SASS
     must hold HMMA instructions, and for float32 inputs the CUDA-core one,
     whose SASS must hold none (both checked after the build)
  4. main path 1, serving: the flagship boolean-circuit model at full width
     behind an ``InferenceEngine`` and a ``MicroBatcher``, fed by client
     threads, then the per-channel MI query ``all_features_bounds``
     (launch counts read around the path), checked against the plain path
  5. main path 2, training: the amorphous per-particle set-transformer
     flagship (1,293,505 parameters) at full width, every attention call
     through the flash kernel, the per-particle MI bounds through
     ``mi_row_stats`` (launch counts read around ``fit``); the only cut is
     the number of steps
  6. one training step on the flash path against the dense path, from the
     same weights, batch and noise; and on that step's own inputs, each
     block's flash q/k/v gradients against float64; then the same pair of
     steps with ``compute_dtype='bfloat16'`` (the tensor-core flash kernel
     against dense bf16 attention with float32 scores), held to the
     gradient's norm
  7. the automatic regime: a full-width set transformer on a set of 1024
     launches the kernel with no flag set
  8. main path 3, the flagship driver: ``run_amorphous_workload`` at full
     width (defaults, flash attention, the 100 x 100 probe grid against a
     512-particle bank, rendering off); the only cuts are the steps and the
     hooks' cadences. Launch counts read around it; one probe call held to
     the plain path; every grid finite inside the g(r) mask
  9. main path 5, the beta sweep: ``run_amorphous_sweep`` at full width
     (8 endpoints, each member the flagship with flash attention, the
     ``SweepInfoPerFeatureHook`` at 1024 x 4, rendering off, 1024
     validation rows so each validation pass is 8 x 1024 sets); the only
     cuts are steps_per_epoch 50 -> 5 and chunk_epochs 25 -> 2 over 4
     epochs. Launch counts read around it (flash 6 per step and per
     validation pass whatever R is; ``mi_row_stats`` 4 per hook call at
     G = 400); the hook's kernel path held to the plain path; replicas 0
     and 7 held to a serial trainer from the same weights, endpoints and
     seeds, beside a serial witness run with dense attention
 9b. main path 6, the north star: phase 9's sweep with
     ``compute_dtype='bfloat16'`` and ``SweepCompressionHook(features=(0,))``
     beside the MI hook; phase 9's checks, every flash launch bf16, the
     float32 contract (parameters, logits, mus, logvars, KL), one .npz of
     [8, 1024, 32] per hook call, each replica's scheme held to its carved
     model's ``encode_feature``; then one bf16 forward and training step of
     the flagship on the card held to the same calls on the CPU, and the
     card step with cuBLAS's reduced-precision bf16 reductions allowed
 10. main path 4, the kernel microbench
     (``dib_tpu_torch.scripts.bench_kernels``, the path of the log-density
     matrix kernel): its record on one line, every arm held to the plain
     materialize-and-reduce arm
 11. CUDA-event timings of the kernels, their plain versions and the
     library call beside their bounds; the MI query, predict, the training
     step (flash and dense), the MI hook, the probe hook and the driver;
     the sweep step, float32 and bfloat16 in turns, beside 8 serial steps,
     the sweep's MI hook beside 8 serial hooks, the validation pass's time
     and peak memory in both types, one compression hook call; profiler
     breakdowns
 12. main path 7, the CLI and durable training, at the CLI's defaults
     (boolean_circuit, the 403,585-parameter ``DistributedIBModel``, batch
     128, 8 steps per epoch, the MI hook at 1024 x 8; cut to 4 + 8 epochs,
     MI bounds and checkpoints every 4): (a) ``train`` in process (8
     ``mi_row_stats`` launches per hook call), then ``python -m
     dib_tpu_torch train`` stopped by SIGTERM in its first chunk (exit 75,
     one checkpoint) and launched again (resumed from epoch 4): its
     history and every leaf of its final checkpoint equal the in-process
     run's bit for bit; (b) the same for the README's sweep command (8
     replicas), every replica finite, replicas 0 and 7 held to serial runs
     of their member seeds beside a one-replica witness (phase 9's
     tolerances over the first two epochs; over the 96 steps, where the
     β = 1 member amplifies rounding, rows to 2e-2 and leaves to 5e-2 of
     their norm); (c) ``run_amorphous_sweep
     (checkpoint_dir=)`` at phase 9's configuration, a hook raising at
     epoch 4 after the checkpoint at 2, the relaunch equal to phase 9's run
     bit for bit (records, weights, the MI bounds measured again); (d)
     ``InferenceEngine.from_checkpoint`` on (a)'s directory against the
     trained weights; (e) one byte flipped in the newest step: quarantined,
     the step before restored; (f) checkpoint save and restore times (the
     north star's stacked state and (a)'s), each CLI run's wall time and
     the boolean step, serial and 8 replicas
 13. main path 8, HTTP serving: ``python -m dib_tpu_torch serve`` over
     phase 12's serial and 8-replica checkpoints, five processes started
     together, each writing its event stream into its ``--outdir`` but the
     fifth (``--telemetry-dir ''``): (a) one process: 200 concurrent predicts and encodes of 1 to
     300 rows (past the top bucket of 128), each held to
     ``InferenceEngine.from_checkpoint`` at 1e-6; wrong width and
     non-finite 400, unknown model and route 404; ``/healthz``,
     ``/v1/models``, ``/metrics`` as JSON and Prometheus text; (b) the sweep
     with ``--sweep_beta_ends``: each β routed to the member nearest in
     log-β and held to that member's carved engine; ``--quota_rps`` gives
     429, ``--admission_limit`` 503, both with ``Retry-After``, and
     ``--response_cache`` a hit marked ``cached``; (c) ``--workers 2`` on
     the card: one worker SIGKILLed mid-service, every call 200, the probe
     respawns it; (d) ``--prefork 2``: both pids serve, ``serve top --once``
     renders the fleet; host-clock timings (requests per second for each,
     latency p50/p99 for 1 and 8 rows at concurrency 1 and 32 beside the
     direct ``engine.predict``, all with the default event stream); the
     stream's price: 1-row latency p50/p99 at concurrency 1 and 32 on the
     single process against the fifth, two rounds in turns; the kernel
     launch counts that each serving
     process publishes on ``/metrics``, read before SIGTERM (the pool's
     engine subprocesses publish none); SIGTERM ends each with exit 0, the
     single process's summary counting every request it served
 14. main path 9, training that survives faults and reports them, every
     event stream read back under the strict schema: (a) the flagship at
     full width, 4 chunks of one epoch with the MI hook and a checkpoint
     each, ``nan@chunk2``: rolled back and replayed, its history, MI
     bounds, weights and Adam moments equal the uninterrupted fit's bit
     for bit; a poison that the checkpoint holds raises after its
     rollbacks; (b) the 8-member sweep at phase 9's widths, member 5
     poisoned once: healed, all eight bit for bit the uninterrupted sweep;
     poisoned in every restore (``PoisonedReplicaRestore``): ejected, the
     other seven bit for bit; (c) ``InfoPerFeatureHook`` and
     ``SweepInfoPerFeatureHook`` with ``overlap=True`` against
     ``overlap=False``: bounds and history bit for bit, each call's exposed
     host time, and the profiler's count of ``mi_row_stats`` kernels off
     the training stream; (d) ``python -m dib_tpu_torch train --watchdog``
     at phase 12's cuts with a checkpoint per epoch and
     ``DIB_FAULT_PLAN=stall@chunk2:30s,kill@chunk4``: exit 0 after a stall
     kill and a crash restart, ``history.npz`` bit for bit the
     uninterrupted run's; the seconds from detection to recovery of each
 15. main path 10, the event stream end to end (nothing trained; phases
     12-15 write in strict mode): (a) phase 13's streams: every event
     valid, run_start (mode serve) first, metrics and run_end last, the
     single process's ok request spans as many as the ok answers and its
     batch spans' rows as many as the rows sent, the prefork workers'
     ``worker0/`` and ``worker1/`` under one trace id; (b) phase 12's sweep
     checkpoint as a zoo in this process, one member behind a
     ``FlakyEngine`` failed until ejected and re-admitted by a probe: the
     faults and the ejection then re-admission on its stream; (c) three
     servers in this process over phase 12's serial checkpoint, served in
     turns by one client at concurrency 1: two clean (4000 predicts each),
     one slowed by ``FlakyEngine(delay_s=0.01)`` (500); (d) ``python -m dib_tpu_torch
     telemetry summarize`` on the serve run, phase 12's serial and sweep
     runs, phase 14's rollback run and a clean run (request counts as
     sent, the server's p50 within the client's, the rollback's nan
     injected, detected and recovered), ``compare --threshold 0.5`` (clean
     pair exit 0, the slowed run exit 1 on its dispatch p99), ``report``
     for every run and ``--index`` for the runs root, and ``runs list``
     holding the runs that phase 12 registered through ``DIB_RUNS_ROOT``
     and phase 13 through ``--runs-root``
 16. main path 11, every dataset and three more workloads: (a) ``train
     --dataset diabetes`` in this process at the CLI's defaults from the
     committed CSV (``data_source`` real; the MI hook at 1024 x 8, G = 10)
     and ``mice_protein``'s synthetic fallback (G = 77), phase 12's cuts;
     (b) ``fetch_double_pendulum`` at its defaults, 1000 trajectories
     simulated on the card (wall time; every kept state within 1e-3 of the
     energy its initial condition was drawn at), then ``train --dataset
     double_pendulum --infonce_loss`` (cut to 8 steps per epoch); (c)
     ``run_boolean_workload`` at its defaults, 2,000 steps (cut from
     50,000) with an MI check every 250: 8 overlapped checks, the last
     equal bit for bit to a direct ``channel_mi_bounds``, the step time;
     (d) ``run_radial_shells_workload`` at its defaults, 20 + 40 epochs
     (cut from 200 + 2000) with an MI check every 5 epochs (cut from
     200): 12 checks, the peak shell profile reaching 0.05 bits, and the
     kernel-vs-plain call on the weights of the check with the largest
     bounds, whose lower bounds must reach 1e-2 nats; (e) ``run_characterization`` at its defaults
     (5 channel types x 7 scales x 3 batch sizes x 8 repeats), lower <=
     upper + 0.02 bits in every cell. Each run's launch counts are read
     around it, and one MI call of each goes through the kernel and the
     plain version within 1e-4 nats
 17. one JSON line listing each ported kernel
 18. the last line: ``{"ok": true, "device": {...}}``

Without a CUDA device it exits nonzero before printing any result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch

SEED = 0
F32_TOL = 2e-5            # kernel vs plain, float32 inputs
DIAG_TOL = 1e-6           # the density matrix's diagonal, u ~= mu at small variance
BF16_TOL = 2e-2           # kernel vs plain, bfloat16 inputs
GRAD_TOL = 1e-4           # flash gradients, and scores scaled by 100
SERVE_TOL = 1e-6          # batched vs direct dispatch
BOUNDS_TOL = 1e-4         # nats per feature, kernel path vs plain path
PATH_TOL = 1e-4           # flash vs dense training step, relative to the gradient's norm
NOISE_MULT = 10           # flash attention gradients: error against float64, x dense's error
ATTN_FLOOR = 1e-5         # ... plus this share of the gradient's norm
EVAL_BATCH, EVAL_BATCHES = 1024, 8
TRAIN_STEPS, STEPS_PER_EPOCH, EVAL_EVERY = 40, 10, 10   # cut from 25,000 steps
# the driver: 40 steps of one epoch each (the reference's per-step beta), MI
# bounds every 10 and probe maps every 20 steps (cut from 250 and 1000)
DRIVER_STEPS, DRIVER_EVAL_EVERY, DRIVER_PROBE_EVERY = 40, 10, 20
# the sweep: 4 epochs of 5 steps (cut from 50), the MI hook every 2 (from 25)
SWEEP_EPOCHS, SWEEP_STEPS_PER_EPOCH, SWEEP_CHUNK = 4, 5, 2
# synthetic neighbourhoods, 15% held out: 1024 validation rows, so each
# validation pass is the north star's 8 x 1024 sets (flash at B = 8192)
SWEEP_NEIGHBORHOODS = 6827
SWEEP_TOL = 1e-4          # a sweep replica vs the serial trainer, relative
SWEEP_FLIPS = 3           # ... its accuracy rows: predictions flipped per epoch
SWEEP_BIAS_TOL = 5e-2     # ... each bias leaf, relative to its norm
SWEEP_HELD = (0, 7)       # the replicas held to the serial trainer
# bfloat16 compute (phases 6 and 9b), relative to the gradient's norm: the
# flash step vs the dense step with float32 scores (both round p to bf16
# before p . v; 4e-4 to 1.4e-3 apart on four CPU batches at full width,
# each 1-2% from the float32 step); the card's step vs the CPU's, and at
# most BF16_SHARE of the CPU's own bf16-vs-float32 spread
BF16_PATH_TOL = 2e-2
BF16_STEP_TOL = 2e-2
BF16_SHARE = 0.25
BF16_MODEL = {"compute_dtype": "bfloat16"}
# H100 SXM published peaks: f32 on the CUDA cores, dense bf16 tensor cores,
# HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def fail(message: str):
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def compare(name, got, want, tol):
    """Max abs/rel error over output tuples; fails beyond atol = rtol = tol
    (as ``numpy.testing.assert_allclose`` holds the JAX package's kernels).
    Returns the errors and the tolerance, as keys of the ``kernels`` line."""
    worst_abs = worst_rel = 0.0
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        worst_abs = max(worst_abs, diff.max().item())
        worst_rel = max(worst_rel, (diff / w.float().abs().clamp_min(1e-30)).max().item())
        if not torch.isfinite(g).all() or not bool((diff <= tol + tol * w.float().abs()).all()):
            fail(f"{name}: kernel disagrees with the plain version "
                 f"(max abs {worst_abs:.3e}, max rel {worst_rel:.3e}, tol {tol})")
    print(f"check {name}: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} tol={tol}")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, "atol": tol, "rtol": tol}


def channel_inputs(gen, g, n, d, dtype=torch.float32, m=None, probe=False, lv_range=None):
    """Random channel parameters; u drawn from its own row's Gaussian (the
    diagonal-dominant regime of the sandwich bounds) unless ``probe``.
    ``lv_range`` draws the log-variances uniformly from (low, high) instead."""
    m = n if m is None else m
    mus = 2.0 * torch.randn(g, m, d, generator=gen, device="cuda")
    if lv_range is None:
        lv = 0.7 * torch.randn(g, m, d, generator=gen, device="cuda") - 1.0
    else:
        low, high = lv_range
        lv = low + (high - low) * torch.rand(g, m, d, generator=gen, device="cuda")
    if probe:
        u = 2.0 * torch.randn(g, n, d, generator=gen, device="cuda")
    else:
        u = mus + torch.randn(g, n, d, generator=gen, device="cuda") * torch.exp(0.5 * lv)
    return u.to(dtype), mus.to(dtype), lv.to(dtype)


def binary_channel_inputs(gen, g, n, logvar=-3.0):
    """The boolean workload's channels at initialisation: mu = +-1, logvar
    -3 (d = 1), u drawn from its own row's Gaussian."""
    mus = (2.0 * torch.randint(0, 2, (g, n, 1), generator=gen, device="cuda") - 1.0)
    lv = torch.full_like(mus, logvar)
    u = mus + torch.randn(g, n, 1, generator=gen, device="cuda") * math.exp(0.5 * logvar)
    return u, mus, lv


def row_stats_plain(u, mus, lv, diagonal=True, groups=25):
    """The plain row statistics, ``groups`` groups at a time: it forms a
    [groups, N, M, d] tensor, 3.4 GB at N = M = 1024, d = 32."""
    from dib_tpu_torch.ops import density

    parts = [density.mi_row_stats_reference(u[i:i + groups], mus[i:i + groups],
                                            lv[i:i + groups], diagonal=diagonal)
             for i in range(0, u.shape[0], groups)]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def attention_inputs(gen, b, s, h, d, dtype=torch.float32, scale=1.0):
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(3))
    return (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)


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


def host_ms(fns: dict, runs: int = 10, warmup: int = 2) -> dict:
    """Median host-clock ms of each call, ending in a synchronise; the calls
    are taken in turns so that drift of the card touches all alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    samples = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(s) for name, s in samples.items()}


def profile_breakdown(fn, top: int = 6, unprofiled_ms: float | None = None) -> str:
    """Device time of one warm call of ``fn`` by kernel, from torch.profiler:
    the sum over device-side kernel events only (an op or a range that
    launched a kernel carries the same time again, and is not counted), its
    share of the profiled call's wall time and, given ``unprofiled_ms``, of
    the call's time without the profiler; then the largest kernels.
    "not measured" when the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return "not measured (no device activity recorded)"
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    parts = [f"{e.key[:60]} {e.self_device_time_total:.1f} us x{e.count}" for e in kernels[:top]]
    share = "" if unprofiled_ms is None else \
        f", {busy_us / (unprofiled_ms * 1e3):.1%} of the unprofiled {unprofiled_ms:.4f} ms"
    return (f"wall {wall_us:.1f} us (profiled), device kernels {busy_us:.1f} us in "
            f"{sum(e.count for e in kernels)} launches ({busy_us / wall_us:.1%} of it{share}); "
            + "; ".join(parts))


def bound(ops, nbytes, peak_flops):
    """Least time on an H100 (ms) and what sets it."""
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def row_stats_bound_ms(g, n, m, d, itemsize, diagonal=True):
    """The row statistics: per (row, column) pair 4 f32 operations per
    channel dim (difference, scale, square-accumulate as an FMA) plus the
    normaliser (2); one online reduction, max, subtract, exp and add (4) per
    entry it takes: the whole row in probe mode, j != i in square mode,
    where each row then merges its diagonal in once (max, two subtracts,
    two exps, add, log, add: 8). The inputs read once and the outputs
    written once."""
    if diagonal:
        ops = g * n * m * (4 * d + 2) + 4 * g * n * (m - 1) + 8 * g * n
    else:
        ops = g * n * m * (4 * d + 2 + 4)
    nbytes = (g * n * d + 2 * g * m * d) * itemsize + (3 if diagonal else 1) * g * n * 4
    return bound(ops, nbytes, PEAK_F32_FLOPS)


def log_density_mat_bound_ms(n, m, d):
    """The density matrix: per entry 4 f32 operations per channel dim
    (difference 1, scale 1, square-accumulate as an FMA 2, the count the
    peak's FMA takes and the row statistics use) plus the normaliser (2);
    u, mu and lv read once and the [N, M] f32 matrix written once."""
    return bound(n * m * (4 * d + 2), (n * d + 2 * m * d) * 4 + n * m * 4, PEAK_F32_FLOPS)


def log_density_mat_issue_floor_ms(n, m, d):
    """The density matrix at the FP32 issue rate: the direct difference
    costs an FADD, an FMUL and an FFMA per (entry, channel), three issue
    slots, and the card issues one f32 instruction per lane and cycle (half
    the FMA peak's operations)."""
    return 3 * n * m * d / (PEAK_F32_FLOPS / 2) * 1e3


def flash_bound_ms(b, s, h, d, dtype):
    """Attention: 4 B H S^2 D operations (the q.k and p.v products) at the
    peak of the input type; q, k, v read once and the f32 output written once."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return bound(4 * b * h * s * s * d, 3 * b * s * h * d * itemsize + b * s * h * d * 4, peak)


def cuobjdump_path():
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def print_registers(path):
    """Prints each kernel's registers, stack and local memory from
    ``cuobjdump -res-usage`` and returns them as {function line: usage line}."""
    cuobjdump = cuobjdump_path()
    if not os.path.exists(cuobjdump):
        fail("cuobjdump not found: cannot read the kernels' resource usage")
    res = subprocess.run([cuobjdump, "-res-usage", str(path)], capture_output=True, text=True,
                         timeout=60, check=True)
    usage, function = {}, None
    for line in res.stdout.splitlines():
        if "REG" in line or "Function" in line:
            print("  " + line.strip())
        if "Function" in line:
            function = line.strip()
        elif function is not None and "REG:" in line:
            usage[function] = line.strip()
            function = None
    return usage


def check_no_spills(usage, path, kernels):
    """Fails unless each named kernel is in ``usage`` (from
    :func:`print_registers`) with no stack and no local memory (no spills)."""
    for kernel in kernels:
        line = next((u for function, u in usage.items() if kernel in function), "")
        fields = dict(field.split(":", 1) for field in line.split())
        if fields.get("STACK") != "0" or fields.get("LOCAL") != "0":
            fail(f"{kernel}: expected in {path.name} with no stack and no spills, "
                 f"found {line or None}")


def check_tensor_cores(path):
    """Counts the HMMA (tensor-core) instructions in the SASS of each
    instantiation of the flash kernels: fails if a bf16 one has none or an
    f32 one (exact f32 FMAs on the CUDA cores) has any. Prints each flash
    kernel's dynamic shared memory per block."""
    import ctypes

    from dib_tpu_torch.ops import _build

    smem_bytes = _build.load("flash_attention").flash_attention_smem_bytes
    smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int], ctypes.c_int
    print(f"  flash_attention dynamic shared memory per block: f32 kernel "
          f"{smem_bytes(0)} bytes, bf16 kernel {smem_bytes(1)} bytes")
    cuobjdump = cuobjdump_path()
    if not os.path.exists(cuobjdump):
        fail("cuobjdump not found: cannot show that the bf16 flash kernel uses the tensor cores")
    res = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                         timeout=120, check=True)
    hmma, function = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1].strip()
            hmma[function] = 0
        elif function is not None and "HMMA" in line:
            hmma[function] += 1
    bf16 = {name: n for name, n in hmma.items() if "flash_attention_bf16_kernel" in name}
    f32 = {name: n for name, n in hmma.items() if "flash_attention_kernel" in name}
    for name, n in {**bf16, **f32}.items():
        print(f"  SASS {name}: {n} HMMA instructions")
    if len(bf16) != 2 or min(bf16.values()) == 0:
        fail(f"flash_attention_bf16_kernel: expected two instantiations with HMMA "
             f"instructions in their SASS, found {bf16}")
    if len(f32) != 2 or max(f32.values()) != 0:
        fail(f"flash_attention_kernel: expected two f32 instantiations without HMMA "
             f"instructions in their SASS, found {f32}")


# --------------------------------------------------------------------------
# phase 3: the kernels against their plain versions

def check_row_stats():
    from dib_tpu_torch.ops import density

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("square G=10 N=1024 d=32 f32", channel_inputs(gen, 10, 1024, 32), True, F32_TOL),
        ("square G=50 N=1024 d=32 f32", channel_inputs(gen, 50, 1024, 32), True, F32_TOL),
        ("ragged G=3 N=1000 d=37 f32", channel_inputs(gen, 3, 1000, 37), True, F32_TOL),
        ("single row G=2 N=1 d=32 f32", channel_inputs(gen, 2, 1, 32), True, F32_TOL),
        ("square G=10 N=1024 d=32 bf16",
         channel_inputs(gen, 10, 1024, 32, torch.bfloat16), True, BF16_TOL),
        ("probe M=10000 N=512 d=32 f32",
         channel_inputs(gen, 1, 10000, 32, m=512, probe=True), False, F32_TOL),
        # the beta sweep's grid (8 betas x 50 particles)
        ("square G=400 N=1024 d=32 f32", channel_inputs(gen, 400, 1024, 32), True, F32_TOL),
        ("probe M=1000 N=4096 d=32 f32",
         channel_inputs(gen, 1, 1000, 32, m=4096, probe=True), False, F32_TOL),
        # the diagonal on a tile's edges
        ("two rows G=3 N=2 d=32 f32", channel_inputs(gen, 3, 2, 32), True, F32_TOL),
        ("ragged G=3 N=33 d=32 f32", channel_inputs(gen, 3, 33, 32), True, F32_TOL),
        ("widest G=4 N=300 d=64 f32", channel_inputs(gen, 4, 300, 64), True, F32_TOL),
        # the untrained flagship's log-variances (PERF.md): the direct difference
        ("logvar -26..20 G=4 N=1024 d=32 f32",
         channel_inputs(gen, 4, 1024, 32, lv_range=(-26.0, 20.0)), True, F32_TOL),
        # phase 16's shapes: the boolean circuit's binary channels (mu = +-1,
        # logvar -3: nearly one-hot rows), the radial shells' and the
        # characterization's d = 8, and mice_protein's 77 channels
        ("binary G=10 N=1024 d=1 f32", binary_channel_inputs(gen, 10, 1024), True, F32_TOL),
        ("square G=20 N=1024 d=8 f32", channel_inputs(gen, 20, 1024, 8), True, F32_TOL),
        ("single group G=1 N=64 d=8 f32", channel_inputs(gen, 1, 64, 8), True, F32_TOL),
        ("square G=77 N=1024 d=32 f32", channel_inputs(gen, 77, 1024, 32), True, F32_TOL),
    ]
    for name, (u, mus, lv), diagonal, tol in cases:
        got = density.mi_row_stats(u, mus, lv, diagonal=diagonal)
        torch.cuda.synchronize()
        want = row_stats_plain(u, mus, lv, diagonal=diagonal)
        splits = density.kernel_column_splits(u.shape[0], u.shape[1], mus.shape[1],
                                              torch.cuda.current_device())
        compare(f"mi_row_stats {name} ({splits} column split{'s' if splits > 1 else ''})",
                got, want, tol)
    single = density.mi_row_stats(*cases[3][1])
    if not bool((single[2] == density.NEG_INF).all()):
        fail("N=1 off-diagonal row is not the large-finite mask value")


def check_flash():
    from dib_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [
        ("flagship B=32 S=50 H=12 D=128 f32", attention_inputs(gen, 32, 50, 12, 128), F32_TOL),
        ("validation B=307 S=50 H=12 D=128 f32",
         attention_inputs(gen, 307, 50, 12, 128), F32_TOL),
        ("sweep step B=8x32 S=50 H=12 D=128 f32",
         attention_inputs(gen, 8 * 32, 50, 12, 128), F32_TOL),
        ("sweep validation B=8x1024 S=50 H=12 D=128 f32",
         attention_inputs(gen, 8 * 1024, 50, 12, 128), F32_TOL),
        ("B=4 S=1024 H=12 D=128 f32", attention_inputs(gen, 4, 1024, 12, 128), F32_TOL),
        ("ragged B=4 S=37 H=12 D=128 f32", attention_inputs(gen, 4, 37, 12, 128), F32_TOL),
        ("single key B=4 S=1 H=12 D=128 f32", attention_inputs(gen, 4, 1, 12, 128), F32_TOL),
        ("q, k x 100 B=4 S=64 H=12 D=128 f32",
         attention_inputs(gen, 4, 64, 12, 128, scale=100.0), GRAD_TOL),
        ("narrow B=4 S=70 H=12 D=16 f32", attention_inputs(gen, 4, 70, 12, 16), F32_TOL),
        ("unaligned D=37 B=4 S=50 H=12 f32 (synchronous staging)",
         attention_inputs(gen, 4, 50, 12, 37), F32_TOL),
        ("unaligned strides B=4 S=50 H=12 D=128 f32 (synchronous staging)",
         tuple(torch.nn.functional.pad(t, (0, 1))[..., 1:]
               for t in attention_inputs(gen, 4, 50, 12, 128)), F32_TOL),
        ("fused qkv view B=32 S=50 H=12 D=128 f32",
         torch.randn(32, 50, 3, 12, 128, generator=gen, device="cuda").unbind(2), F32_TOL),
        # bfloat16: the tensor-core kernel, its cp.async staging unless noted
        ("B=4 S=1024 H=12 D=128 bf16",
         attention_inputs(gen, 4, 1024, 12, 128, torch.bfloat16), BF16_TOL),
        ("flagship B=32 S=50 H=12 D=128 bf16",
         attention_inputs(gen, 32, 50, 12, 128, torch.bfloat16), BF16_TOL),
        ("validation B=307 S=50 H=12 D=128 bf16",
         attention_inputs(gen, 307, 50, 12, 128, torch.bfloat16), BF16_TOL),
        ("ragged B=4 S=37 H=12 D=128 bf16",
         attention_inputs(gen, 4, 37, 12, 128, torch.bfloat16), BF16_TOL),
        ("single key B=4 S=1 H=12 D=128 bf16",
         attention_inputs(gen, 4, 1, 12, 128, torch.bfloat16), BF16_TOL),
        ("narrow B=4 S=70 H=12 D=16 bf16",
         attention_inputs(gen, 4, 70, 12, 16, torch.bfloat16), BF16_TOL),
        ("unaligned D=37 B=4 S=50 H=12 bf16 (synchronous staging)",
         attention_inputs(gen, 4, 50, 12, 37, torch.bfloat16), BF16_TOL),
        ("unaligned strides B=4 S=50 H=12 D=128 bf16 (synchronous staging)",
         tuple(torch.nn.functional.pad(t, (0, 1))[..., 1:]
               for t in attention_inputs(gen, 4, 50, 12, 128, torch.bfloat16)), BF16_TOL),
        ("fused qkv view B=32 S=50 H=12 D=128 bf16",
         tuple(torch.randn(32, 50, 3, 12, 128, generator=gen, device="cuda")
               .to(torch.bfloat16).unbind(2)), BF16_TOL),
        ("q, k x 100 B=4 S=64 H=12 D=128 bf16",
         attention_inputs(gen, 4, 64, 12, 128, torch.bfloat16, scale=100.0), BF16_TOL),
        # the untrained flagship's block 0 (|scale q . k| ~ 1e8): p must keep its max at 2^0
        ("q, k x 1e4 B=4 S=50 H=12 D=128 bf16",
         attention_inputs(gen, 4, 50, 12, 128, torch.bfloat16, scale=1e4), BF16_TOL),
        ("q, k x 1e4 B=4 S=50 H=12 D=128 f32",
         attention_inputs(gen, 4, 50, 12, 128, scale=1e4), F32_TOL),
        # the north star's bf16 sweep: a step's 8 x 32 sets and a validation pass's 8 x 1024
        ("sweep step B=8x32 S=50 H=12 D=128 bf16",
         attention_inputs(gen, 8 * 32, 50, 12, 128, torch.bfloat16), BF16_TOL),
        ("sweep validation B=8x1024 S=50 H=12 D=128 bf16",
         attention_inputs(gen, 8 * 1024, 50, 12, 128, torch.bfloat16), BF16_TOL),
    ]
    errors = {}
    for name, (q, k, v), tol in cases:
        before = attention.flash_attention_launches
        got = attention.flash_self_attention(q, k, v)
        torch.cuda.synchronize()
        if attention.flash_attention_launches != before + 1:
            fail(f"flash_attention {name}: the call did not launch the kernel")
        errors[name] = compare(f"flash_attention {name}", [got],
                               [attention.flash_self_attention_reference(q, k, v)], tol)
    # gradients: the autograd function (kernel forward, blocked recompute
    # backward) against autograd through the plain version
    for b, s, dtype, label, tol in ((4, 1024, torch.float32, "f32", GRAD_TOL),
                                    (4, 1024, torch.bfloat16, "bf16", BF16_TOL),
                                    (8 * 32, 50, torch.float32, "f32 (sweep step)", GRAD_TOL),
                                    (8 * 32, 50, torch.bfloat16, "bf16 (sweep step)", BF16_TOL)):
        q, k, v = (t.requires_grad_() for t in attention_inputs(gen, b, s, 12, 128, dtype))
        attention.flash_self_attention(q, k, v).square().sum().backward()
        got = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        attention.flash_self_attention_reference(q, k, v).square().sum().backward()
        compare(f"flash_attention gradients dq, dk, dv B={b} S={s} H=12 D=128 {label}", got,
                [t.grad for t in (q, k, v)], tol)
    return errors[cases[0][0]], errors["sweep step B=8x32 S=50 H=12 D=128 bf16"]


def density_inputs(rng, n, m, d):
    """The microbench's inputs (numpy-seeded, as ``bench_kernels``)."""
    def tensor(a):
        return torch.as_tensor(a.astype(np.float32), device="cuda")

    return (tensor(rng.normal(scale=2.0, size=(n, d))),
            tensor(rng.normal(scale=2.0, size=(m, d))),
            tensor(rng.normal(scale=0.7, size=(m, d)) - 1.0))


def check_log_density_mat():
    """The density matrix kernel at the microbench's shapes (square, ragged,
    probe), the flagship's probe shape, a ragged channel axis of two d
    chunks, one wider than a ring stage, a row count past the old grid's
    cap of 64 x 65,535 (about 50 MB of output, rows not 16-byte aligned),
    and the diagonal-precision case. Returns {shape: errors}."""
    from dib_tpu_torch.ops import density

    rng = np.random.default_rng(SEED + 8)
    errors = {}
    for n, m, d in ((512, 512, 16), (1024, 1024, 32), (1000, 1000, 32), (4096, 4096, 32),
                    (1000, 4096, 32), (10_000, 512, 32), (130, 33, 45), (1, 1, 1),
                    (1000, 1000, 100), (64 * 65_535 + 1, 3, 1)):
        u, mus, lv = density_inputs(rng, n, m, d)
        got = density.log_density_matrix(u, mus, lv)
        torch.cuda.synchronize()
        if got.shape != (n, m) or got.dtype != torch.float32:
            fail(f"log_density_mat N={n} M={m} d={d}: output {tuple(got.shape)} {got.dtype}")
        errors[(n, m, d)] = compare(f"log_density_mat N={n} M={m} d={d} f32", [got],
                                    [density.gaussian_log_density_mat(u, mus, lv)], F32_TOL)
    # the diagonal: u ~= mu at variance e^-6, where the norm expansion would cancel
    n, d = 1024, 32
    mus = torch.as_tensor(rng.normal(scale=3.0, size=(n, d)).astype(np.float32), device="cuda")
    lv = torch.full((n, d), -6.0, device="cuda")
    u = mus + torch.as_tensor(rng.normal(scale=np.exp(-3.0), size=(n, d)).astype(np.float32),
                              device="cuda")
    got = density.log_density_matrix(u, mus, lv)
    want = density.gaussian_log_density_mat(u, mus, lv)
    compare(f"log_density_mat N=M={n} d={d} logvar=-6 whole matrix", [got], [want], F32_TOL)
    compare(f"log_density_mat N=M={n} d={d} logvar=-6 diagonal",
            [torch.diagonal(got)], [torch.diagonal(want)], DIAG_TOL)
    return errors


# --------------------------------------------------------------------------
# phase 4: main path 1, serving and the MI query

def serve_and_query():
    from dib_tpu_torch.data import get_dataset
    from dib_tpu_torch.models import DistributedIBModel
    from dib_tpu_torch.ops import attention, density
    from dib_tpu_torch.ops.gaussian import reparameterize
    from dib_tpu_torch.ops.info_bounds import sandwich_from_row_stats
    from dib_tpu_torch.serve import InferenceEngine, MicroBatcher
    from dib_tpu_torch.train.hooks import all_features_bounds

    bundle = get_dataset("boolean_circuit")
    model = DistributedIBModel(
        bundle.feature_dimensionalities, output_dim=bundle.output_dimensionality,
        device="cuda", generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: DistributedIBModel F={model.num_features} params={n_params}")
    engine = InferenceEngine(model, device="cuda")
    rows_np = np.asarray(bundle.x_valid, np.float32)

    density.mi_row_stats_launches = 0
    attention.flash_attention_launches = 0
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
    launches = {"mi_row_stats": density.mi_row_stats_launches,
                "flash_attention": attention.flash_attention_launches}
    print(f"main path launches (serve + MI query): {json.dumps(launches)}")
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
    return dict(model=model, engine=engine, rows=rows, rows_np=rows_np, mi_gen=mi_gen,
                stats_in=stats_in, launches=launches)


# --------------------------------------------------------------------------
# phase 5: main path 2, training the per-particle flagship

def train_flagship():
    from dib_tpu_torch.data import get_dataset
    from dib_tpu_torch.ops import attention, density
    from dib_tpu_torch.ops.schedules import log_annealed_beta
    from dib_tpu_torch.train import DIBTrainer, Every, InfoPerFeatureHook
    from dib_tpu_torch.workloads import AmorphousWorkloadConfig, build_model

    config = AmorphousWorkloadConfig()
    run = dataclasses.replace(config, num_steps=TRAIN_STEPS, eval_every=EVAL_EVERY)
    train_config = run.train_config(STEPS_PER_EPOCH)
    bundle = get_dataset("amorphous_particles")
    model = build_model(config, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_flash=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: PerParticleDIBModel P={model.num_particles} blocks=6 heads=12 key_dim=128 "
          f"params={n_params}; data {bundle.extras['source']} "
          f"train={bundle.x_train.shape[0]} valid={bundle.x_valid.shape[0]}; "
          f"cut: num_steps {config.num_steps} -> {TRAIN_STEPS} "
          f"({train_config.num_epochs} epochs x {STEPS_PER_EPOCH} steps), nothing else")
    if n_params != 1_293_505:
        fail(f"the flagship has {n_params} parameters, expected 1,293,505")
    trainer = DIBTrainer(model, bundle, train_config)
    hook = InfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches, seed=SEED)
    cadence = max(run.eval_every // STEPS_PER_EPOCH, 1)

    density.mi_row_stats_launches = 0
    attention.flash_attention_launches = 0
    t0 = time.perf_counter()
    state, history = trainer.fit(torch.Generator(device="cuda").manual_seed(SEED),
                                 hooks=[Every(cadence, hook)], hook_every=cadence)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"mi_row_stats": density.mi_row_stats_launches,
                "flash_attention": attention.flash_attention_launches}
    print(f"main path launches (training, {TRAIN_STEPS} steps, {train_config.num_epochs} "
          f"validation passes, {len(hook.records)} MI hook calls): {json.dumps(launches)}")
    blocks = len(model.aggregator.blocks)
    want_flash = blocks * (TRAIN_STEPS + train_config.num_epochs)
    if launches["flash_attention"] < want_flash:
        fail(f"flash_attention launched {launches['flash_attention']} times in training, "
             f"expected {blocks} per step and per validation pass ({want_flash})")
    if not hook.records or launches["mi_row_stats"] < config.mi_eval_batches * len(hook.records):
        fail(f"mi_row_stats launched {launches['mi_row_stats']} times for "
             f"{len(hook.records)} MI hook calls, expected {config.mi_eval_batches} per call")

    for name in ("loss", "val_loss", "metric", "val_metric", "kl_per_feature"):
        if not np.isfinite(getattr(history, name)).all():
            fail(f"training: non-finite {name}")
    epochs = np.arange(train_config.num_epochs)
    want_beta = log_annealed_beta(torch.from_numpy(epochs), train_config.beta_start,
                                  train_config.beta_end, train_config.num_annealing_epochs,
                                  train_config.num_pretraining_epochs).numpy()
    if not np.array_equal(history.beta, want_beta) or not (np.diff(history.beta) > 0).all():
        fail(f"training: beta {history.beta} does not follow the log ramp {want_beta}")
    bounds = np.asarray([r["bounds"] for r in hook.records])        # [T, P, 2] nats
    if bounds.shape != (len(hook.records), model.num_particles, 2) or \
            not np.isfinite(bounds).all():
        fail(f"training: MI bounds of shape {bounds.shape} or non-finite")
    if not (bounds[..., 0] <= bounds[..., 1] + BOUNDS_TOL).all():
        fail("training: a per-particle lower bound exceeds its upper bound")
    if not (bounds[..., 0] <= math.log(config.mi_eval_batch_size) + BOUNDS_TOL).all():
        fail("training: a per-particle InfoNCE lower bound exceeds log(batch)")
    print(f"training: {TRAIN_STEPS} steps in {train_s:.3f} s (first call, kernels built); "
          f"beta {history.beta.tolist()}; loss {history.loss.tolist()}; "
          f"val_loss {history.val_loss.tolist()}; total KL (nats) "
          f"{history.total_kl.tolist()}; MI hook at epochs {hook.epochs.tolist()}: "
          f"mean lower {bounds[..., 0].mean(-1).tolist()} mean upper "
          f"{bounds[..., 1].mean(-1).tolist()} nats over {model.num_particles} particles")
    return dict(config=config, train_config=train_config, bundle=bundle, trainer=trainer,
                state=state, hook=hook, launches=launches)


# --------------------------------------------------------------------------
# phase 6: one step on the flash path against the dense path

def exact_attention(q, k, v):
    """Softmax attention in float64, the reference both float32 recipes are
    measured against."""
    q, k, v = q.double(), k.double(), v.double()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def capture_attention(model):
    """Records, for each block of ``model`` in its next forward and backward,
    a copy of the attention module as it was (weights before the optimizer
    step), the module's input and the gradient of its output. Returns the
    list it fills and the hook handles."""

    records, handles = [], []

    def forward_hook(module, inputs, output):
        record = [copy.deepcopy(module), inputs[0].detach()]
        records.append(record)
        output.register_hook(lambda grad: record.append(grad.detach()))

    for block in model.aggregator.blocks:
        handles.append(block.attention.register_forward_hook(forward_hook))
    return records, handles


def hold_attention_gradients(records):
    """Holds the flash attention's q, k and v gradients to float64 on each
    block's own inputs from the training step: its q, k, v and the gradient
    that reached its attention core. The error of each must stay within
    NOISE_MULT times the dense recipe's own error (also against float64)
    plus ATTN_FLOOR of the gradient's norm. Block 0's softmax is nearly
    one-hot, and there every float32 recipe misses dq and dk by far more
    than elsewhere; the other blocks see post-LayerNorm inputs with scores
    of standard deviation near 1."""
    from dib_tpu_torch.ops import attention

    recipes = (("flash", attention.flash_self_attention, torch.float32),
               ("dense", attention.dense_self_attention, torch.float32),
               ("exact", exact_attention, torch.float64))
    lines = []
    for i, (module, u, d_out) in enumerate(records):
        with torch.no_grad():
            q, k, v = module.query(u), module.key(u), module.value(u)
            d_core = torch.einsum("bso,hdo->bshd", d_out, module.out.kernel)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
            max_p = torch.softmax(scores, -1).amax(-1).mean().item()
        grads = {}
        for name, fn, dtype in recipes:
            leaves = [t.to(dtype).clone().requires_grad_() for t in (q, k, v)]
            fn(*leaves).backward(d_core.to(torch.float64 if name == "exact" else torch.float32))
            grads[name] = [leaf.grad.double() for leaf in leaves]
        errs = []
        for j, tensor in enumerate("qkv"):
            exact = grads["exact"][j]
            scale = exact.norm().item()
            err_flash = (grads["flash"][j] - exact).norm().item() / scale
            err_dense = (grads["dense"][j] - exact).norm().item() / scale
            if err_flash > NOISE_MULT * err_dense + ATTN_FLOOR:
                fail(f"block {i}: flash d{tensor} misses float64 by {err_flash:.3e} of its norm, "
                     f"dense by {err_dense:.3e}; limit {NOISE_MULT} x dense + {ATTN_FLOOR}")
            errs.append(f"d{tensor} {err_flash:.2e}/{err_dense:.2e}")
        lines.append(f"block {i} (score std {scores.std().item():.3g}, max p {max_p:.3f}): "
                     + " ".join(errs))
    print(f"check flash attention gradients on the training step's own inputs, error of "
          f"flash/dense against float64 (of the norm), tol {NOISE_MULT} x dense + "
          f"{ATTN_FLOOR}: " + "; ".join(lines))


def compare_paths(flagship):
    """One training step through the flash kernel against one through the
    dense attention, from the same weights, batch and noise.

    The whole step is held by its loss, KL and gradient against the
    gradient's norm: per leaf it cannot be, because the model's ReLUs make
    the gradient jump where a pre-activation crosses zero, and a last-bit
    difference between two recipes' forwards can flip a unit (of the kernel
    path's forward and its plain version alike). The kernel path's own
    gradients are held per tensor at the attention core of every block
    (``hold_attention_gradients``), on the inputs this step gave it."""
    from dib_tpu_torch.ops import attention
    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.workloads import build_model

    config, train_config = flagship["config"], flagship["train_config"]
    flash_model = build_model(config, device="cuda", use_flash=True,
                              generator=torch.Generator().manual_seed(SEED + 2))
    dense_model = build_model(config, device="cuda", use_flash=False,
                              generator=torch.Generator().manual_seed(SEED + 2))
    dense_model.load_state_dict(flash_model.state_dict())
    bundle, batch = flagship["bundle"], train_config.batch_size
    x = torch.as_tensor(bundle.x_train[:batch], device="cuda")
    y = torch.as_tensor(bundle.y_train[:batch], device="cuda")
    eps = torch.randn(flash_model.noise_shape(train_config.batch_size),
                      generator=torch.Generator(device="cuda").manual_seed(SEED + 2),
                      device="cuda")
    beta = train_config.beta_start
    steps = {}
    records, handles = capture_attention(flash_model)
    for name, model in (("flash", flash_model), ("dense", dense_model)):
        trainer = DIBTrainer(model, bundle, train_config)
        state, _ = trainer.init()
        before = attention.flash_attention_launches
        stats = trainer.train_step(state, x, y, beta, eps)
        torch.cuda.synchronize()
        launched = attention.flash_attention_launches - before
        if launched != (len(model.aggregator.blocks) if name == "flash" else 0):
            fail(f"{name} training step launched the flash kernel {launched} times")
        steps[name] = (trainer, state, stats,
                       {n: p.grad.detach().clone() for n, p in model.named_parameters()})
    for handle in handles:
        handle.remove()
    (_, _, fs, fg), (_, _, ds, dg) = steps["flash"], steps["dense"]
    loss_err = max(abs(fs["task"].item() - ds["task"].item()),
                   (fs["kl"] - ds["kl"]).abs().max().item())
    scale = torch.sqrt(sum(g.square().sum() for g in dg.values())).item()
    diffs = {n: (fg[n] - g).norm().item() for n, g in dg.items()}
    worst = max(diffs, key=diffs.get)
    if diffs[worst] > PATH_TOL * scale:
        fail(f"flash vs dense step: gradient {worst} differs by {diffs[worst]:.3e}, "
             f"above {PATH_TOL} of the gradient's norm {scale:.3e}")
    if loss_err > PATH_TOL * max(1.0, abs(ds["task"].item())):
        fail(f"flash vs dense step: task loss or KL differ by {loss_err:.3e}")
    total = math.sqrt(sum(d * d for d in diffs.values()))
    print(f"check training step flash vs dense (same weights, batch, noise): task "
          f"{fs['task'].item():.7f} vs {ds['task'].item():.7f}, loss/KL max_abs_err "
          f"{loss_err:.3e}; gradient norm {scale:.4e}, difference {total:.3e} "
          f"({total / scale:.3e} of it), worst leaf {worst} {diffs[worst]:.3e}; "
          f"tol {PATH_TOL} of the norm")
    hold_attention_gradients(records)
    return dict(x=x, y=y, eps=eps, beta=beta, flash=steps["flash"][:2],
                dense=steps["dense"][:2], dense_grads=dg)


def relative_distance(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every leaf of two gradients."""
    diff = math.sqrt(sum((got[n] - w).float().square().sum().item() for n, w in want.items()))
    return diff / math.sqrt(sum(w.float().square().sum().item() for w in want.values()))


def compare_paths_bf16(flagship, step):
    """Phase 6 in bfloat16: one training step of the bf16 flagship through
    the tensor-core flash kernel against one through dense bf16 attention
    with float32 scores (``DIB_ATTN_SCORE_DTYPE=float32``: the same rounding
    points, p rounded to bfloat16 before p . v), from phase 6's weights,
    batch and noise. Held as phase 6 holds float32, by the loss, KL and
    gradient against the gradient's norm (BF16_PATH_TOL; block 0's near
    one-hot softmax is where a wrong row sum in the flash backward shows:
    it once moved the flash step by 27%). Printed beside it: each step's
    distance from phase 6's float32 dense step, and the dense step's with
    bfloat16 scores, the default."""
    from dib_tpu_torch.ops import attention
    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.workloads import build_model

    config, train_config, bundle = flagship["config"], flagship["train_config"], flagship["bundle"]
    stats, grads = {}, {}
    saved_env = os.environ.get("DIB_ATTN_SCORE_DTYPE")
    for name, use_flash, scores in (("flash", True, None), ("dense", False, "float32"),
                                    ("dense bf16 scores", False, "bfloat16")):
        model = build_model(config, device="cuda", use_flash=use_flash,
                            generator=torch.Generator().manual_seed(SEED + 2), **BF16_MODEL)
        trainer = DIBTrainer(model, bundle, train_config)
        state, _ = trainer.init()
        before = (attention.flash_attention_launches, attention.flash_attention_bf16_launches)
        if scores is not None:
            os.environ["DIB_ATTN_SCORE_DTYPE"] = scores
        try:
            stats[name] = trainer.train_step(state, step["x"], step["y"], step["beta"],
                                             step["eps"])
        finally:
            if saved_env is None:
                os.environ.pop("DIB_ATTN_SCORE_DTYPE", None)
            else:
                os.environ["DIB_ATTN_SCORE_DTYPE"] = saved_env
        torch.cuda.synchronize()
        launched = (attention.flash_attention_launches - before[0],
                    attention.flash_attention_bf16_launches - before[1])
        blocks = len(model.aggregator.blocks)
        if launched != ((blocks, blocks) if use_flash else (0, 0)):
            fail(f"bf16 {name} training step launched the flash kernel {launched} times "
                 "(all, bf16)")
        grads[name] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        if any(p.dtype != torch.float32 for p in model.parameters()) or \
                any(t.dtype != torch.float32 for t in stats[name].values()):
            fail(f"bf16 {name} training step: a parameter or a statistic is not float32")
    fs, ds = stats["flash"], stats["dense"]
    loss_err = max(abs(fs["task"].item() - ds["task"].item()),
                   (fs["kl"] - ds["kl"]).abs().max().item())
    path = relative_distance(grads["flash"], grads["dense"])
    spread = {name: relative_distance(g, step["dense_grads"]) for name, g in grads.items()}
    print(f"check bf16 training step flash vs dense with f32 scores (same weights, batch, "
          f"noise): task {fs['task'].item():.7f} vs {ds['task'].item():.7f}, loss/KL "
          f"max_abs_err {loss_err:.3e}; gradient difference {path:.3e} of its norm, tol "
          f"{BF16_PATH_TOL}; distance from the f32 dense step: flash {spread['flash']:.3e}, "
          f"dense {spread['dense']:.3e}, dense with bf16 scores (the default) "
          f"{spread['dense bf16 scores']:.3e}")
    if path > BF16_PATH_TOL or not all(torch.isfinite(g).all() for g in grads["flash"].values()):
        fail(f"bf16 flash vs dense step: the gradients differ by {path:.3e} of their norm")
    if loss_err > BF16_PATH_TOL * max(1.0, abs(ds["task"].item())):
        fail(f"bf16 flash vs dense step: task loss or KL differ by {loss_err:.3e}")


# --------------------------------------------------------------------------
# phase 7: the automatic regime

def auto_regime():
    from dib_tpu_torch.models import SetTransformer
    from dib_tpu_torch.ops import attention

    model = SetTransformer(device="cuda", generator=torch.Generator().manual_seed(SEED + 4))
    x = torch.randn(4, 1024, 32, generator=torch.Generator(device="cuda").manual_seed(SEED + 4),
                    device="cuda")
    attention.flash_attention_launches = 0
    out = model(x)
    out.sum().backward()
    torch.cuda.synchronize()
    launched = attention.flash_attention_launches
    if launched != len(model.blocks) or not bool(torch.isfinite(out).all()):
        fail(f"auto regime: {launched} flash launches for a set of 1024 with use_flash=None, "
             f"expected {len(model.blocks)}")
    for block in model.blocks:
        block.attention.use_flash = False
    with torch.no_grad():
        err = (model(x) - out).abs().max().item()
    if err > GRAD_TOL:
        fail(f"auto regime: the flash forward differs from the dense one by {err:.3e}")
    print(f"auto regime: SetTransformer on [4, 1024, 32] with use_flash=None launched the "
          f"flash kernel {launched} times (forward + backward); vs dense forward "
          f"max_abs_err={err:.3e} tol={GRAD_TOL}")


# --------------------------------------------------------------------------
# phase 8: main path 3, the flagship driver with its probe maps

def drive_amorphous():
    from dib_tpu_torch.ops import attention, density, info_bounds
    from dib_tpu_torch.ops.gaussian import reparameterize
    from dib_tpu_torch.viz.probe_maps import density_mask
    from dib_tpu_torch.workloads import (
        AmorphousWorkloadConfig,
        pair_correlation,
        probe_features_for_type,
        probe_grid_positions,
        probe_info_maps,
        run_amorphous_workload,
    )

    config = dataclasses.replace(AmorphousWorkloadConfig(), num_steps=DRIVER_STEPS,
                                 eval_every=DRIVER_EVAL_EVERY, probe_every=DRIVER_PROBE_EVERY)
    print(f"driver: run_amorphous_workload, AmorphousWorkloadConfig() at full width, "
          f"use_flash=True, grid {config.grid_side}x{config.grid_side} against a bank of "
          f"{config.probe_data_batch}; cut: num_steps 25000 -> {DRIVER_STEPS}, eval_every "
          f"250 -> {DRIVER_EVAL_EVERY}, probe_every 1000 -> {DRIVER_PROBE_EVERY}; render=False")
    density.mi_row_stats_launches = 0
    attention.flash_attention_launches = 0
    density.log_density_mat_launches = 0
    t0 = time.perf_counter()
    result = run_amorphous_workload(SEED, config, outdir="amorphous_out",
                                    model_overrides={"use_flash": True}, render=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"mi_row_stats": density.mi_row_stats_launches,
                "flash_attention": attention.flash_attention_launches,
                "log_density_mat": density.log_density_mat_launches}
    info_calls, probe_calls = len(result["mi_epochs"]), len(result["probe_grids"])
    print(f"main path launches (driver, {DRIVER_STEPS} steps, {info_calls} MI hook calls, "
          f"{probe_calls} probe hook calls): {json.dumps(launches)}")
    if info_calls != DRIVER_STEPS // DRIVER_EVAL_EVERY or \
            probe_calls != DRIVER_STEPS // DRIVER_PROBE_EVERY:
        fail(f"driver: {info_calls} MI hook calls and {probe_calls} probe hook calls")
    probe_launches = launches["mi_row_stats"] - config.mi_eval_batches * info_calls
    if probe_launches != 2 * probe_calls:
        fail(f"driver: {launches['mi_row_stats']} mi_row_stats launches, of which "
             f"{probe_launches} probe-mode; expected 2 per probe call ({2 * probe_calls})")
    want_flash = 6 * 2 * DRIVER_STEPS          # 6 blocks, per step and per validation pass
    if launches["flash_attention"] != want_flash:
        fail(f"driver: {launches['flash_attention']} flash launches, expected {want_flash}")

    history = result["history"]
    for name in ("loss", "val_loss", "kl_per_feature"):
        if not np.isfinite(getattr(history, name)).all():
            fail(f"driver: non-finite {name}")
    bounds = result["mi_bounds_bits"]
    if bounds.shape != (info_calls, config.number_particles, 2) or not np.isfinite(bounds).all():
        fail(f"driver: MI bounds of shape {bounds.shape} or non-finite")
    sets = result["bundle"].extras["sets_train"]
    positions = probe_grid_positions(config.grid_side, config.grid_extent)
    g_r, edges = pair_correlation(sets)
    inside = ~np.isnan(density_mask(positions, g_r, edges[1:], config.grid_side))
    cap = math.log(config.probe_data_batch + 1) + BOUNDS_TOL
    for epoch, grids in result["probe_grids"].items():
        for grid in grids:
            if grid.shape != (config.grid_side, config.grid_side, 2) or \
                    not np.isfinite(grid[inside]).all():
                fail(f"driver: probe grid at epoch {epoch} of shape {grid.shape} or "
                     "non-finite inside the g(r) mask")
            if not (grid[inside][:, 0] <= cap).all():
                fail(f"driver: an InfoNCE probe bound at epoch {epoch} exceeds log(bank + 1)")

    # one probe call on the trained model, then the same u through the plain path
    model = result["state"].params["model"]
    particles = torch.as_tensor(sets.reshape(-1, sets.shape[-1]), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    idx = torch.randint(0, particles.shape[0], (config.probe_data_batch,), generator=gen,
                        device="cuda")
    eps = tuple(torch.randn(len(positions), model.embedding_dim, generator=gen, device="cuda")
                for _ in range(2))
    before = density.mi_row_stats_launches
    grids = probe_info_maps(model, particles, config, draws=(idx, eps))
    if density.mi_row_stats_launches - before != 2:
        fail(f"probe call: {density.mi_row_stats_launches - before} launches, expected 2")
    # The lower bounds are at most log(bank + 1) = 6.24 nats and are held to
    # BOUNDS_TOL absolute. The upper bounds of the untrained flagship reach
    # ~1e6 nats inside the g(r) mask and ~4e8 outside (encoder log-variances
    # down to -26), where one float32 ulp is up to 32 nats, so they are held
    # as every kernel here is held: to BOUNDS_TOL absolute plus BOUNDS_TOL of
    # their magnitude.
    worst_lower = 0.0
    with torch.inference_mode():
        data_mus, data_lv = model.encode_feature(0, particles[idx])
        for type_id, eps_t, grid in zip((1, 2), eps, grids):
            feats = torch.as_tensor(probe_features_for_type(positions, type_id), device="cuda")
            mus, lv = model.encode_feature(0, feats)
            u = reparameterize(mus, lv, eps=eps_t)
            kernel = torch.stack(info_bounds.mi_sandwich_probe(mus, lv, data_mus, data_lv, u=u),
                                 -1).cpu().numpy().reshape(grid.shape)
            info_bounds.mi_row_stats = density.mi_row_stats_reference
            try:
                plain = torch.stack(info_bounds.mi_sandwich_probe(mus, lv, data_mus, data_lv,
                                                                  u=u), -1)
            finally:
                info_bounds.mi_row_stats = density.mi_row_stats
            plain = plain.cpu().numpy().reshape(grid.shape)
            if not np.array_equal(kernel, grid):
                fail(f"probe call: probe_info_maps type {type_id} differs from "
                     "mi_sandwich_probe on the same draws")
            err = float(np.abs(kernel[..., 0] - plain[..., 0]).max())
            worst_lower = max(worst_lower, err)
            if err > BOUNDS_TOL or not np.isfinite(kernel).all():
                fail(f"probe call type {type_id}: kernel path vs plain path lower bounds "
                     f"differ by {err:.3e} nats (tol {BOUNDS_TOL})")
            worst_upper = compare(f"probe call type {type_id} upper bounds, kernel vs plain path "
                                  f"(|bound| up to {np.abs(plain[..., 1]).max():.4g} nats)",
                                  [torch.from_numpy(kernel[..., 1])],
                                  [torch.from_numpy(plain[..., 1])], BOUNDS_TOL)
    last = result["probe_grids"][max(result["probe_grids"])]
    print(f"driver: {DRIVER_STEPS} steps in {wall_s:.3f} s (host clock, one run); loss "
          f"{history.loss[::10].tolist()} bits; MI hook at epochs {result['mi_epochs'].tolist()}; "
          f"probe grids at epochs {sorted(result['probe_grids'])}, finite inside the g(r) mask "
          f"({int(inside.sum())} of {inside.size} points); last maps' mean lower/upper (nats, "
          f"inside the mask) type A {last[0][inside].mean(0).tolist()} type B "
          f"{last[1][inside].mean(0).tolist()}; one probe call kernel vs plain lower bounds "
          f"max_abs_err={worst_lower:.3e} tol={BOUNDS_TOL}, upper bounds max_abs_err="
          f"{worst_upper['max_abs_err']:.3e}")
    return dict(config=config, result=result, wall_s=wall_s, launches=launches,
                probe_launches=probe_launches)


# --------------------------------------------------------------------------
# phase 9: main path 5, the beta sweep

def run_sweep(config, hooks, model_overrides, **kwargs):
    """``run_amorphous_sweep`` at full width with phase 9's cuts, the launch
    counts set to 0 just before and read just after, and the group axis of
    every ``mi_row_stats`` call recorded; ``kwargs`` go to ``run_amorphous_sweep``.
    Returns (result, groups, launches, peak device memory in GB)."""
    from dib_tpu_torch.ops import attention, density, info_bounds
    from dib_tpu_torch.workloads import run_amorphous_sweep

    groups = []
    plain_call = info_bounds.mi_row_stats

    def counting(u, mus, logvars, diagonal=True):
        groups.append(u.shape[0])
        return plain_call(u, mus, logvars, diagonal)

    density.mi_row_stats_launches = 0
    attention.flash_attention_launches = 0
    attention.flash_attention_bf16_launches = 0
    density.log_density_mat_launches = 0
    torch.cuda.reset_peak_memory_stats()
    info_bounds.mi_row_stats = counting
    try:
        result = run_amorphous_sweep(SEED, config, steps_per_epoch=SWEEP_STEPS_PER_EPOCH,
                                     chunk_epochs=SWEEP_CHUNK, hooks=hooks, render=False,
                                     model_overrides=model_overrides,
                                     num_synthetic_neighborhoods=SWEEP_NEIGHBORHOODS, **kwargs)
    finally:
        info_bounds.mi_row_stats = plain_call
    torch.cuda.synchronize()
    launches = {"mi_row_stats": density.mi_row_stats_launches,
                "flash_attention": attention.flash_attention_launches,
                "flash_attention_bf16": attention.flash_attention_bf16_launches,
                "log_density_mat": density.log_density_mat_launches}
    return result, groups, launches, torch.cuda.max_memory_allocated() / 1e9


def drive_sweep():
    from dib_tpu_torch.data import get_dataset
    from dib_tpu_torch.parallel import SweepInfoPerFeatureHook
    from dib_tpu_torch.workloads import AmorphousWorkloadConfig

    config = dataclasses.replace(AmorphousWorkloadConfig(),
                                 num_steps=SWEEP_EPOCHS * SWEEP_STEPS_PER_EPOCH)
    hook = SweepInfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches, seed=SEED)
    print(f"sweep: run_amorphous_sweep, 8 endpoints np.logspace(-2, 0, 8), each member the "
          f"flagship at full width with use_flash=True, SweepInfoPerFeatureHook at "
          f"{config.mi_eval_batch_size} x {config.mi_eval_batches}, {SWEEP_NEIGHBORHOODS} "
          f"synthetic neighbourhoods (1024 validation rows); cut: steps_per_epoch 50 -> "
          f"{SWEEP_STEPS_PER_EPOCH}, chunk_epochs 25 -> {SWEEP_CHUNK}, {SWEEP_EPOCHS} epochs "
          f"({config.num_steps} steps); render=False")
    result, groups, launches, peak_gb = run_sweep(config, [hook], {"use_flash": True})
    model, records = result["states"].params["model"], result["records"]
    replicas, steps = model.replicas, SWEEP_EPOCHS * SWEEP_STEPS_PER_EPOCH
    bounds = check_sweep_run("sweep", result, hook, groups, launches, config, peak_gb)
    bundle = get_dataset("amorphous_particles", number_particles_to_use=config.number_particles,
                         num_synthetic_neighborhoods=SWEEP_NEIGHBORHOODS)
    if len(bundle.x_valid) != config.train_config().max_val_points:
        fail(f"sweep: {len(bundle.x_valid)} validation rows, expected "
             f"{config.train_config().max_val_points}")
    hook_err, hook_upper_err = hold_sweep_hook(model, bundle, config)
    serial_errs = hold_sweep_replicas(result, bundle, config)
    print(f"sweep: {steps} steps x {replicas} replicas in {result['wall_clock_s']:.3f} s (host "
          f"clock, one run, first call); final loss per replica "
          f"{[round(float(r.loss[-1]), 6) for r in records]}; MI hook at epochs "
          f"{hook.epochs.tolist()}, mean lower bound per replica (nats) "
          f"{bounds[-1, ..., 0].mean(-1).round(5).tolist()}; hook kernel vs plain path lower "
          f"bounds max_abs_err={hook_err:.3e} tol={BOUNDS_TOL}, upper bounds max_abs_err="
          f"{hook_upper_err:.3e}; {serial_errs}")
    return dict(config=config, result=result, hook=hook, bundle=bundle, launches=launches,
                peak_gb=peak_gb)


def check_sweep_run(label, result, hook, groups, launches, config, peak_gb):
    """The checks phases 9 and 9b share: 8 members of 1,293,505 parameters;
    6 flash launches per step and per validation pass whatever R is;
    ``mi_row_stats`` 4 times per hook call over G = R x P groups; every
    replica finite with its own beta ramp; the MI bounds finite, lower below
    upper and below log(batch). Returns the bounds [T, R, P, 2] in nats."""
    from dib_tpu_torch.ops.schedules import log_annealed_beta

    model = result["states"].params["model"]
    ends, records = result["beta_ends"], result["records"]
    replicas = len(ends)
    n_params = sum(p.numel() for p in model.parameters())
    steps = SWEEP_EPOCHS * SWEEP_STEPS_PER_EPOCH
    calls = len(hook.records)
    print(f"main path launches ({label}, R={replicas}, {steps} steps, {SWEEP_EPOCHS} validation "
          f"passes, {calls} MI hook calls): {json.dumps(launches)}; mi_row_stats groups per "
          f"call {groups}; peak device memory {peak_gb:.3f} GB")
    if replicas != 8 or model.replicas != 8 or n_params != 8 * 1_293_505:
        fail(f"{label}: {replicas} members of {n_params / max(replicas, 1)} parameters, "
             f"expected 8 of 1,293,505")
    want_flash = len(model.aggregator.blocks) * (steps + SWEEP_EPOCHS)
    if launches["flash_attention"] != want_flash:
        fail(f"{label}: {launches['flash_attention']} flash launches, expected {want_flash} "
             f"(6 per step and per validation pass, whatever R is)")
    if calls != SWEEP_EPOCHS // SWEEP_CHUNK or \
            launches["mi_row_stats"] != config.mi_eval_batches * calls or \
            groups != [replicas * config.number_particles] * launches["mi_row_stats"]:
        fail(f"{label}: {calls} MI hook calls, {launches['mi_row_stats']} mi_row_stats launches "
             f"over groups {groups}; expected {config.mi_eval_batches} per call at "
             f"G = {replicas * config.number_particles}")
    epochs = torch.arange(SWEEP_EPOCHS)
    for r, (end, record) in enumerate(zip(ends, records)):
        for name in ("loss", "val_loss", "metric", "val_metric", "kl_per_feature"):
            if not np.isfinite(getattr(record, name)).all():
                fail(f"{label}: replica {r} has non-finite {name}")
        want_beta = log_annealed_beta(epochs, config.beta_start, float(end),
                                      SWEEP_EPOCHS).numpy()
        if not np.allclose(record.beta, want_beta, rtol=1e-6, atol=0.0) or \
                not (np.diff(record.beta) > 0).all():
            fail(f"{label}: replica {r} beta {record.beta} does not follow its endpoint {end}")
    bounds = np.stack([rec["bounds"] for rec in hook.records])     # [T, R, P, 2] nats
    if bounds.shape != (calls, replicas, config.number_particles, 2) or \
            not np.isfinite(bounds).all() or \
            not (bounds[..., 0] <= bounds[..., 1] + BOUNDS_TOL).all() or \
            not (bounds[..., 0] <= math.log(config.mi_eval_batch_size) + BOUNDS_TOL).all():
        fail(f"{label}: MI bounds of shape {bounds.shape}, non-finite or out of order")
    return bounds


def hold_sweep_hook(model, bundle, config):
    """One SweepInfoPerFeatureHook measurement on the trained sweep: the
    kernel path against the plain row statistics on the same draws, 25
    groups at a time. Returns the largest differences (nats) of the lower
    and of the upper bounds."""
    from dib_tpu_torch.ops import density
    from dib_tpu_torch.ops.gaussian import reparameterize
    from dib_tpu_torch.ops.info_bounds import sandwich_from_row_stats
    from dib_tpu_torch.parallel.sweep_hooks import sweep_features_bounds

    rows = torch.as_tensor(bundle.x_valid, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    batch, batches, replicas = config.mi_eval_batch_size, config.mi_eval_batches, model.replicas
    idx = torch.randint(0, len(rows), (batches, replicas, batch), generator=gen, device="cuda")
    plain_lower, plain_upper, us = [], [], []
    with torch.inference_mode():
        for b in range(batches):
            mus, lv = model.encode(rows[idx[b]])                   # [R, P, B, d]
            u = reparameterize(mus, lv, gen)
            us.append(u)
            stats = row_stats_plain(*(t.reshape(-1, *t.shape[2:]).contiguous()
                                      for t in (u, mus, lv)), groups=25)
            lower, upper = sandwich_from_row_stats(*stats)
            plain_lower.append(lower.reshape(mus.shape[:2]))
            plain_upper.append(upper.reshape(mus.shape[:2]))
        before = density.mi_row_stats_launches
        k_lower, k_upper = sweep_features_bounds(model, rows, batch, batches, idx=idx,
                                                 u=torch.stack(us))
        torch.cuda.synchronize()
    if density.mi_row_stats_launches - before != batches:
        fail(f"sweep hook check: {density.mi_row_stats_launches - before} launches, "
             f"expected {batches}")
    # The lower bounds are at most log(batch) = 6.93 nats and are held to
    # BOUNDS_TOL absolute. The upper bounds of the briefly trained flagship
    # reach ~1e5 nats, where one float32 ulp is ~0.008, so they are held as
    # the probe call's are: BOUNDS_TOL absolute plus BOUNDS_TOL of their size.
    p_lower, p_upper = torch.stack(plain_lower).mean(0), torch.stack(plain_upper).mean(0)
    err = (k_lower - p_lower).abs().max().item()
    if err > BOUNDS_TOL or not torch.isfinite(torch.cat([k_lower, k_upper])).all():
        fail(f"sweep hook: kernel path vs plain path lower bounds differ by {err:.3e} nats "
             f"(tol {BOUNDS_TOL})")
    upper = compare(f"sweep hook upper bounds, kernel vs plain path (|bound| up to "
                    f"{p_upper.abs().max().item():.4g} nats)", [k_upper], [p_upper], BOUNDS_TOL)
    return err, upper["max_abs_err"]


def serial_sweep_member(config, bundle, train_config, r, beta_end, use_flash):
    """Member ``r`` of the sweep trained alone by a serial DIBTrainer from its
    own seed: (state dict, history)."""
    from dib_tpu_torch.parallel import member_seed
    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.workloads import build_model

    seed = member_seed(SEED, r)
    model = build_model(config, device="cuda", use_flash=use_flash,
                        generator=torch.Generator().manual_seed(seed))
    trainer = DIBTrainer(model, bundle, dataclasses.replace(train_config, beta_end=beta_end))
    _, history = trainer.fit(torch.Generator(device="cuda").manual_seed(seed))
    return model.state_dict(), history


def hold_sweep_replicas(result, bundle, config):
    """Replicas ``SWEEP_HELD`` against a serial DIBTrainer from the same
    initial weights, endpoint and seed, over the same steps (flash
    attention, as in the sweep): history rows to SWEEP_TOL relative, each
    weight leaf to SWEEP_TOL of its norm.

    The biases start at zero and after the warm-up steps hold only a few
    Adam steps, which Adam normalises: float32 noise in their small,
    cancelling gradient sums moves them by up to a few percent of their
    norm whichever way the sums are rounded, most in block 0's query bias,
    whose saturated attention (phase 6) leaves every float32 recipe ~1e-4
    off in dq. A witness measures that spread: the same member trained
    serially with dense attention instead of flash (the same function,
    other roundings); its readings are printed beside the replica's. Each
    bias leaf is held to SWEEP_BIAS_TOL of its norm, a limit set from card
    readings of both (see PERF.md). The attention's key bias, whose
    gradient is zero in exact arithmetic, moves by Adam-normalised
    rounding noise only: it must stay within 2 x the summed learning rates
    of zero in both runs. The accuracy rows are a step function of the
    logits, and the untrained flagship's logits crowd around 0, where a
    last-bit difference flips a prediction: they are held to at most
    SWEEP_FLIPS flipped predictions per epoch (the loss rows beside them
    stay held to SWEEP_TOL); the witness's flips are printed beside them."""
    from dib_tpu_torch.scripts.sweep_drift import leaf_errors

    train_config = config.train_config(SWEEP_STEPS_PER_EPOCH)
    steps = SWEEP_EPOCHS * SWEEP_STEPS_PER_EPOCH
    summed_lr = config.learning_rate * sum(min(u / config.warmup_steps, 1.0)
                                           for u in range(steps))
    predictions = {"metric": SWEEP_STEPS_PER_EPOCH * train_config.batch_size,
                   "val_metric": min(len(bundle.x_valid), train_config.max_val_points)}
    stacked = result["states"].params["model"].state_dict()
    lines = []
    for r in SWEEP_HELD:
        end = float(result["beta_ends"][r])
        want, history = serial_sweep_member(config, bundle, train_config, r, end, True)
        witness, witness_history = serial_sweep_member(config, bundle, train_config, r, end,
                                                       False)
        record = result["records"][r]
        rows = {}
        for name in ("beta", "kl_per_feature", "loss", "val_loss"):
            got, serial = getattr(record, name), getattr(history, name)
            rel = np.abs(got - serial) / np.maximum(np.abs(serial), 1e-30)
            rows[name] = (got, serial, float(np.where(got == serial, 0.0, rel).max()))
        flips = {name: [np.rint(np.abs(getattr(run, name) - getattr(history, name)) * count)
                        .astype(int).tolist() for run in (record, witness_history)]
                 for name, count in predictions.items()}
        errs = leaf_errors({name: stacked[name][r] for name in want}, want)
        spread = leaf_errors(witness, want)
        key_bias = max(max(stacked[name][r].abs().max().item(), want[name].abs().max().item())
                       for name in want if name.endswith("attention.key.bias"))
        weights = {n: e for n, e in errs.items() if not n.endswith(".bias")}
        biases = {n: (e, spread[n]) for n, e in errs.items()
                  if n.endswith(".bias") and not n.endswith("attention.key.bias")}
        print(f"sweep replica {r} biases, (replica vs serial, witness vs serial) relative to "
              f"the leaf's norm: " + json.dumps({name: [float(f"{e:.4g}"), float(f"{w:.4g}")]
                                                  for name, (e, w) in biases.items()}))
        lines.append(f"replica {r} vs serial trainer: history max rel err "
                     f"{max(e for *_, e in rows.values()):.3e}, weights max rel err "
                     f"{max(weights.values()):.3e} (tol {SWEEP_TOL}; witness "
                     f"{max(spread[n] for n in weights):.3e}), biases max rel err "
                     f"{max(e for e, _ in biases.values()):.3e} (tol {SWEEP_BIAS_TOL}; witness "
                     f"{max(w for _, w in biases.values()):.3e}), key bias {key_bias:.3e} "
                     f"(limit {2 * summed_lr:.3e}), accuracy predictions flipped per epoch, "
                     f"replica and witness, {flips} (limit {SWEEP_FLIPS})")
        for name, (got, serial, _) in rows.items():
            if not np.allclose(got, serial, rtol=SWEEP_TOL, atol=0.0):
                fail(f"sweep replica {r}: history {name} {got} vs serial {serial}")
        for name, (replica_flips, _) in flips.items():
            if max(replica_flips) > SWEEP_FLIPS:
                fail(f"sweep replica {r}: accuracy {name}: {replica_flips} predictions flipped "
                     f"per epoch against the serial run, limit {SWEEP_FLIPS}")
        for name, err in weights.items():
            if err > SWEEP_TOL:
                fail(f"sweep replica {r}: weight {name} differs from the serial run by "
                     f"{err:.3e} of its norm")
        for name, (err, witness_err) in biases.items():
            if err > SWEEP_BIAS_TOL:
                fail(f"sweep replica {r}: bias {name} differs from the serial run by {err:.3e} "
                     f"of its norm (the witness by {witness_err:.3e})")
        if key_bias > 2 * summed_lr:
            fail(f"sweep replica {r}: attention key bias {key_bias:.3e} beyond 2 x the summed "
                 f"learning rates {summed_lr:.3e}")
    return "; ".join(lines)


# --------------------------------------------------------------------------
# phase 9b: main path 6, the north star in bfloat16

def drive_northstar():
    """The reference's north-star configuration: phase 9's sweep with
    ``compute_dtype='bfloat16'`` (flash attention on the tensor-core kernel)
    and, beside the MI hook, ``SweepCompressionHook(features=(0,))``, the
    schemes written to a temporary directory. The same cuts and checks as
    phase 9, and: every flash launch bfloat16; parameters, logits, mus,
    logvars and KL float32; one .npz per hook call holding [8, 1024, 32]
    finite channel parameters, each replica's equal (BF16_TOL, atol = rtol)
    to ``model.carve(r).encode_feature(0, rows)`` on the card."""
    import tempfile

    from dib_tpu_torch.data import get_dataset
    from dib_tpu_torch.ops.schedules import log_annealed_beta
    from dib_tpu_torch.parallel import SweepCompressionHook, SweepInfoPerFeatureHook
    from dib_tpu_torch.workloads import AmorphousWorkloadConfig

    config = dataclasses.replace(AmorphousWorkloadConfig(),
                                 num_steps=SWEEP_EPOCHS * SWEEP_STEPS_PER_EPOCH)
    info = SweepInfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches, seed=SEED)
    with tempfile.TemporaryDirectory(prefix="northstar_schemes_") as outdir:
        schemes = SweepCompressionHook(outdir, features=(0,))
        print(f"north star: phase 9's sweep with compute_dtype='bfloat16', use_flash=True, "
              f"hooks SweepInfoPerFeatureHook({config.mi_eval_batch_size}, "
              f"{config.mi_eval_batches}) and SweepCompressionHook(features=(0,)); same cuts")
        result, groups, launches, peak_gb = run_sweep(config, [info, schemes],
                                                      {**BF16_MODEL, "use_flash": True})
        bounds = check_sweep_run("north star", result, info, groups, launches, config, peak_gb)
        if launches["flash_attention_bf16"] != launches["flash_attention"]:
            fail(f"north star: {launches['flash_attention_bf16']} of "
                 f"{launches['flash_attention']} flash launches were bfloat16")
        model = result["states"].params["model"]
        bundle = get_dataset("amorphous_particles",
                             number_particles_to_use=config.number_particles,
                             num_synthetic_neighborhoods=SWEEP_NEIGHBORHOODS)
        rows = torch.as_tensor(bundle.x_valid, device="cuda")
        check_bf16_outputs("north star", model, rows[None, :64].expand(model.replicas, -1, -1))
        calls = len(info.records)
        want = [f"scheme_epoch{SWEEP_CHUNK * (c + 1)}_feature0.npz" for c in range(calls)]
        if [os.path.basename(rec["path"]) for rec in schemes.saved] != want or \
                sorted(os.listdir(os.path.join(outdir, "schemes"))) != sorted(want):
            fail(f"north star: schemes {schemes.saved}, expected {want}")
        particle_rows = rows[:, :model.particle_feature_dim]     # feature 0's columns
        worst = 0.0
        for rec in schemes.saved:
            with np.load(rec["path"]) as data:
                saved = {name: torch.from_numpy(data[name]) for name in ("mus", "logvars")}
                betas = data["betas"]
            shape = (model.replicas, len(bundle.x_valid), model.embedding_dim)
            if any(t.shape != shape or not torch.isfinite(t).all() for t in saved.values()):
                fail(f"north star: {rec['path']} holds {[tuple(t.shape) for t in saved.values()]}"
                     f", expected {shape} finite")
            want = [float(log_annealed_beta(rec["epoch"], config.beta_start, float(end),
                                            SWEEP_EPOCHS)) for end in result["beta_ends"]]
            if not np.allclose(betas, want):
                fail(f"north star: {rec['path']} betas {betas}, expected {want}")
        with torch.inference_mode():     # the last call saw the final weights
            for r in range(model.replicas):
                mus, logvars = model.carve(r).encode_feature(0, particle_rows)
                err = compare(f"north star scheme replica {r} vs carve({r}).encode_feature",
                              [saved["mus"][r], saved["logvars"][r]],
                              [mus.cpu(), logvars.cpu()], BF16_TOL)
                worst = max(worst, err["max_abs_err"])
    records = result["records"]
    print(f"north star: {SWEEP_EPOCHS * SWEEP_STEPS_PER_EPOCH} steps x {model.replicas} "
          f"replicas in {result['wall_clock_s']:.3f} s (host clock, one run, first call); final "
          f"loss per replica {[round(float(r.loss[-1]), 6) for r in records]}; MI hook at epochs "
          f"{info.epochs.tolist()}, mean lower bound per replica (nats) "
          f"{bounds[-1, ..., 0].mean(-1).round(5).tolist()}; {len(schemes.saved)} schemes "
          f"[{model.replicas}, {len(bundle.x_valid)}, {model.embedding_dim}], vs carve(r) "
          f"max_abs_err={worst:.3e} tol={BF16_TOL}")
    return dict(config=config, result=result, info=info, bundle=bundle, launches=launches,
                peak_gb=peak_gb)


def check_bf16_outputs(label, model, x):
    """A bfloat16 model's contract on the card: float32 parameters, and
    float32 finite logits, mus, logvars and KL from one forward of ``x``."""
    if any(p.dtype != torch.float32 for p in model.parameters()):
        fail(f"{label}: a parameter is not float32")
    with torch.no_grad():
        prediction, aux = model(x, generator=torch.Generator(device=x.device).manual_seed(SEED))
    for name, t in (("logits", prediction), ("mus", aux["mus"]), ("logvars", aux["logvars"]),
                    ("KL", aux["kl_per_feature"])):
        if t.dtype != torch.float32 or not torch.isfinite(t).all():
            fail(f"{label}: {name} is {t.dtype}, or not finite")


def hold_bf16_card_vs_cpu(flagship):
    """One bfloat16 forward and one bfloat16 training step of the full-width
    flagship on the card (the bf16 flash kernel, cuBLAS) against the same
    calls on the CPU (the plain versions, CPU GEMMs), from the same weights,
    batch and noise: the link from the kernels to the CPU parity tests
    against the JAX package. Logits, mus, logvars and KL to BF16_TOL (atol
    = rtol), the gradient to BF16_STEP_TOL of its norm and to BF16_SHARE of
    the CPU's own bf16-vs-float32 spread (the CPU tests' quarter rule: the
    same rounding points). Then the card step again
    with cuBLAS allowed to reduce bf16 products in reduced precision, against
    the port's setting (float32 reductions)."""

    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.workloads import build_model

    config, train_config, bundle = flagship["config"], flagship["train_config"], flagship["bundle"]
    batch, beta = train_config.batch_size, train_config.beta_start
    x = torch.as_tensor(bundle.x_train[-batch:])
    y = torch.as_tensor(bundle.y_train[-batch:])
    base = {}

    def run(device, overrides, reduced=False):
        key = (device, tuple(overrides))
        if key not in base:
            base[key] = build_model(config, device=device, use_flash=True,
                                    generator=torch.Generator().manual_seed(SEED + 13),
                                    **overrides)
        model = copy.deepcopy(base[key])
        eps = torch.randn(model.noise_shape(batch),
                          generator=torch.Generator().manual_seed(SEED + 14)).to(device)
        trainer = DIBTrainer(model, bundle, train_config, device=device)
        state, _ = trainer.init()
        matmul = torch.backends.cuda.matmul
        matmul.allow_bf16_reduced_precision_reduction = reduced
        try:
            with torch.no_grad():
                prediction, aux = model(x.to(device), eps=eps)
            stats = trainer.train_step(state, x.to(device), y.to(device), beta, eps)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = False
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        outputs = [prediction, aux["mus"], aux["logvars"], aux["kl_per_feature"], stats["task"]]
        return [t.detach().cpu() for t in outputs], grads

    card, card_grads = run("cuda", BF16_MODEL)
    cpu, cpu_grads = run("cpu", BF16_MODEL)
    cpu_f32, cpu_f32_grads = run("cpu", {})
    reduced, reduced_grads = run("cuda", BF16_MODEL, reduced=True)
    for name, t in zip(("logits", "mus", "logvars", "KL", "task loss"), card):
        if t.dtype != torch.float32:
            fail(f"bf16 flagship on the card: {name} is {t.dtype}")
    err = compare("bf16 flagship forward and step statistics, card vs CPU (logits, mus, "
                  "logvars, KL, task loss)", card, cpu, BF16_TOL)
    step = relative_distance(card_grads, cpu_grads)
    spread = relative_distance(cpu_grads, cpu_f32_grads)
    logit_spread = (cpu[0] - cpu_f32[0]).abs().max().item()
    flag_logits = (reduced[0] - card[0]).abs().max().item()
    flag_step = relative_distance(reduced_grads, card_grads)
    print(f"check bf16 flagship training step, card vs CPU: gradient difference {step:.3e} of "
          f"its norm, tol {BF16_STEP_TOL}; the CPU's bf16 vs f32 step: {spread:.3e} of the "
          f"norm, logits max_abs_err {logit_spread:.3e} (card vs CPU {err['max_abs_err']:.3e})")
    print(f"check allow_bf16_reduced_precision_reduction=True vs False (the port's setting) on "
          f"the card: logits max_abs_diff {flag_logits:.3e}, gradient difference "
          f"{flag_step:.3e} of its norm")
    if step > BF16_STEP_TOL or not all(torch.isfinite(g).all() for g in card_grads.values()):
        fail(f"bf16 flagship step, card vs CPU: gradients differ by {step:.3e} of their norm")
    if step > BF16_SHARE * spread:
        fail(f"bf16 flagship step, card vs CPU: {step:.3e} of the norm, beyond {BF16_SHARE} x "
             f"the CPU's own bf16 vs f32 spread {spread:.3e}: other rounding points")
    return dict(step=step, spread=spread, flag_logits=flag_logits, flag_step=flag_step)


# --------------------------------------------------------------------------
# phase 12: main path 7, the CLI and durable training

CLI_DEVICE = "cuda"
CLI_COMMAND = [sys.executable, "-m", "dib_tpu_torch"]     # run from the checkout's root
ROOT = os.path.dirname(os.path.abspath(__file__))
# the CLI at its defaults (boolean_circuit, the 403,585-parameter model, batch
# 128, 8 steps per epoch, the MI hook at 1024 x 8); cut: 4 + 8 epochs (from
# 1000 + 10000), MI bounds and checkpoints every 4 epochs (from 500)
CLI_CUTS = ["--number_pretraining_epochs", "4", "--number_annealing_epochs", "8",
            "--info_bounds_frequency", "4", "--checkpoint_frequency", "4"]
CLI_CADENCE, CLI_EPOCHS, CLI_PARAMS = 4, 12, 403_585
CLI_SWEEP = ["--sweep_beta_ends", "0.03", "0.1", "0.3", "1.0", "--sweep_repeats", "2"]
CLI_TIMEOUT = 600
# the CLI sweep's replicas 0 and 7 against serial runs of their member seeds,
# by phase 9's rules over all 96 steps, in float64: in float32 the trajectory
# amplifies rounding (one ulp of one weight of a serial run moves it by up to
# ~1e-3 in 96 steps; PERF.md), and the batched GEMMs of a stack of 8 round
# otherwise than the serial ones. The float32 run is held bit for bit to
# stacks of eight copies of each member: nothing couples the replicas.
# dib_tpu_torch/scripts/sweep_drift.py runs the full set of these comparisons.


def cli_argv(outdir, ckpt, *extra):
    return ["train", "--dataset", "boolean_circuit", "--artifact_outdir", outdir,
            "--checkpoint_dir", ckpt, *CLI_CUTS, *extra]


def cli_in_process(argv):
    """``train`` in this process, the launch counts set to 0 just before
    and read just after: (summary, launches, wall s)."""
    from dib_tpu_torch import cli
    from dib_tpu_torch.ops import attention, density

    density.mi_row_stats_launches = 0
    attention.flash_attention_launches = 0
    attention.flash_attention_bf16_launches = 0
    density.log_density_mat_launches = 0
    t0 = time.perf_counter()
    summary = cli.run(cli.build_parser().parse_args(argv), device=CLI_DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return summary, {"mi_row_stats": density.mi_row_stats_launches,
                     "flash_attention": attention.flash_attention_launches,
                     "flash_attention_bf16": attention.flash_attention_bf16_launches,
                     "log_density_mat": density.log_density_mat_launches}, wall


def cli_subprocess(argv, stop_after=None):
    """``python -m dib_tpu_torch train`` in a process of its own; with
    ``stop_after`` (a checkpoint step's directory), SIGTERM is sent as soon
    as that directory exists, so it lands in the chunk after it. Returns
    (exit code, stdout, stderr, wall s)."""
    import signal
    import tempfile

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as out, tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([*CLI_COMMAND, *argv], cwd=ROOT, env=env, text=True,
                                stdout=out, stderr=err)
        try:
            if stop_after is not None:
                while proc.poll() is None and not os.path.isdir(stop_after):
                    time.sleep(0.001)
                proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=CLI_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        return proc.returncode, out.read(), err.read(), time.perf_counter() - t0


def checkpoint_leaves(ckpt, step):
    with np.load(os.path.join(ckpt, str(step), "leaves.npz"), allow_pickle=False) as data:
        return {name: data[name] for name in data.files}


def same_files(label, got_dir, want_dir, names):
    """Every array of each .npz in ``names`` equal bit for bit."""
    for name in names:
        with np.load(os.path.join(got_dir, name)) as got, \
                np.load(os.path.join(want_dir, name)) as want:
            if got.files != want.files:
                fail(f"{label}: {name} holds {got.files}, expected {want.files}")
            for key in want.files:
                if not np.array_equal(got[key], want[key]):
                    fail(f"{label}: {name}[{key}] differs from the uninterrupted run's")


def same_leaves(label, got, want):
    """Every leaf of two checkpoint steps equal bit for bit; returns the
    number of leaves and of weight leaves."""
    if got.keys() != want.keys():
        fail(f"{label}: the final checkpoints hold other leaves")
    for name, value in want.items():
        if not np.array_equal(got[name], value):
            fail(f"{label}: leaf {name} of the final checkpoint differs from the "
                 f"uninterrupted run's")
    return len(want), sum(name.startswith("params/") for name in want)


def cli_resume(label, tmp, extra, history_files, hook_calls):
    """The CLI run in process, then the same command as a process of its own
    sent SIGTERM once its first checkpoint (epoch 4) exists: it exits 75
    at the next chunk boundary with a chunk-aligned checkpoint there, and
    launched again resumes from it; its history and every leaf of its final
    checkpoint equal the in-process run's bit for bit (the serial MI hook
    draws from a running generator, as the JAX hook does, so its bounds
    after the resume are other draws)."""
    whole, run = os.path.join(tmp, f"{label}_whole"), os.path.join(tmp, f"{label}_run")
    whole_ckpt, run_ckpt = whole + "_ckpt", run + "_ckpt"
    summary, launches, in_process_s = cli_in_process(cli_argv(whole, whole_ckpt, *extra))
    print(f"main path launches (CLI {label}, {CLI_EPOCHS} epochs, {hook_calls} MI hook calls): "
          f"{json.dumps(launches)}")
    want_launches = 8 * hook_calls
    if launches["mi_row_stats"] != want_launches or launches["flash_attention"] or \
            launches["flash_attention_bf16"]:
        fail(f"CLI {label}: launches {launches}, expected {want_launches} mi_row_stats "
             f"(8 per MI hook call) and no attention")
    code, out, err, stopped_s = cli_subprocess(cli_argv(run, run_ckpt, *extra),
                                               stop_after=os.path.join(run_ckpt, str(CLI_CADENCE)))
    with open(os.path.join(run, "run_summary.json")) as f:
        stopped = json.load(f)
    at = stopped.get("preempted_at_epoch")
    steps = sorted(int(s) for s in os.listdir(run_ckpt) if s.isdigit())
    if code != 75 or stopped.get("status") != "preempted" or at not in range(
            CLI_CADENCE, CLI_EPOCHS, CLI_CADENCE) or steps != list(range(CLI_CADENCE, at + 1,
                                                                         CLI_CADENCE)):
        fail(f"CLI {label}: SIGTERM after the checkpoint at epoch {CLI_CADENCE} gave exit "
             f"{code}, summary {stopped}, steps {steps}; expected 75, preempted at a chunk "
             f"boundary before epoch {CLI_EPOCHS} with a checkpoint there\n{err[-3000:]}")
    code, out, err, resumed_s = cli_subprocess(cli_argv(run, run_ckpt, *extra))
    resumed = json.loads(out.strip().splitlines()[-1]) if code == 0 else {}
    if code != 0 or resumed.get("resumed_from_epoch") != at:
        fail(f"CLI {label}: the relaunch gave exit {code}, resumed_from_epoch "
             f"{resumed.get('resumed_from_epoch')}, expected 0 and {at}\n{err[-3000:]}")
    same_files(f"CLI {label}", run, whole, history_files)
    leaves, weights = same_leaves(f"CLI {label}", checkpoint_leaves(run_ckpt, CLI_EPOCHS),
                                  checkpoint_leaves(whole_ckpt, CLI_EPOCHS))
    print(f"CLI {label}: SIGTERM once the checkpoint at epoch {CLI_CADENCE} existed -> exit 75 "
          f"at epoch {at} with checkpoints at {steps}; the relaunch resumed from epoch "
          f"{resumed['resumed_from_epoch']}; {', '.join(history_files)} and all {leaves} leaves "
          f"of the final checkpoint ({weights} weight leaves) equal the uninterrupted run's bit "
          f"for bit; not rendered (no matplotlib): {len(resumed.get('not_rendered', []))} "
          f"plot(s)")
    return dict(summary=summary, launches=launches, whole=whole, whole_ckpt=whole_ckpt,
                resumed_from=at, wall_s={"in process": in_process_s, "stopped by SIGTERM": stopped_s,
                        "relaunched": resumed_s})


def hold_cli_replicas(tmp, sweep):
    """Replicas ``SWEEP_HELD`` of the CLI's sweep.

    (1) The CLI's float32 run, bit for bit: each held replica's history and
    final weights equal the same slot of a stack of eight copies of that
    member (so no other member moves it). (2) Phase 9's rules over the
    whole run, in float64: the sweep of eight (the CLI's members, endpoints and draws)
    against serial runs of the held members' seeds, every history row to
    SWEEP_TOL relative, every kernel leaf to SWEEP_TOL of its norm, every
    bias leaf to SWEEP_BIAS_TOL, at most SWEEP_FLIPS accuracy predictions
    flipped per epoch. (3) Printed, not held: the float32 replica against
    its float32 serial run, beside the float32 serial run with one weight
    moved by one ulp."""
    from dib_tpu_torch.parallel import member_seed
    from dib_tpu_torch.scripts.sweep_drift import ULP, CliMembers, member_errors

    members = CliMembers(cli_argv(tmp, tmp, *CLI_SWEEP), CLI_DEVICE)
    final = checkpoint_leaves(sweep["whole_ckpt"], CLI_EPOCHS)
    cli_sweep, _ = members.cli._model_from_args(members.args, members.bundle, device="cpu",
                                                replicas=8)
    cli_sweep.load_state_dict({name[len("params/model."):]: torch.from_numpy(value)
                               for name, value in final.items() if name.startswith("params/")})
    counts = members.accuracy_counts()
    exact64 = members.stack(list(range(8)), torch.float64)
    lines = []
    for r in SWEEP_HELD:
        copy_r = members.stack([r] * 8)[r]       # member r in slot r, as in the CLI's sweep
        with np.load(os.path.join(sweep["whole"], f"history_replica{r}.npz")) as bits:
            history = types.SimpleNamespace(**{name: bits[name] for name in bits.files})
        leaves = {name: cli_sweep.member_values(name, value, r).double()
                  for name, value in cli_sweep.state_dict().items()}
        for name, value in vars(history).items():
            if not np.array_equal(value, np.asarray(getattr(copy_r[0], name))):
                fail(f"CLI sweep replica {r}: history {name} differs from a stack of eight "
                     f"copies of member {r}")
        for name, value in copy_r[1].items():
            if not torch.equal(leaves[name], value):
                fail(f"CLI sweep replica {r}: weight {name} differs from a stack of eight "
                     f"copies of member {r}")
        rows, errs, flips = member_errors(exact64[r], members.serial(r, torch.float64), counts)
        kernels = {n: e for n, e in errs.items() if not n.endswith(".bias")}
        biases = {n: e for n, e in errs.items() if n.endswith(".bias")}
        if rows.max() > SWEEP_TOL or max(kernels.values()) > SWEEP_TOL or \
                max(biases.values()) > SWEEP_BIAS_TOL or max(flips) > SWEEP_FLIPS:
            fail(f"CLI sweep replica {r} in float64 vs the serial run of member seed "
                 f"{member_seed(SEED, r)}: rows {rows.tolist()} (tol {SWEEP_TOL}), kernels "
                 f"{max(kernels.values()):.3e} (tol {SWEEP_TOL}), biases "
                 f"{max(biases.values()):.3e} (tol {SWEEP_BIAS_TOL}), flips {flips} (limit "
                 f"{SWEEP_FLIPS})")
        serial32 = members.serial(r)
        drift = member_errors((history, leaves), serial32, counts)
        nudged = member_errors(members.serial(r, nudge=ULP), serial32, counts)
        print(f"CLI sweep replica {r}, float32, not held: vs its serial run, per epoch "
              f"{[float(f'{e:.3g}') for e in drift[0]]}, leaves up to "
              f"{max(drift[1].values()):.3e}, flips {drift[2]}; the serial run with its first "
              f"integration kernel x (1 + 2^-23) vs the serial run, per epoch "
              f"{[float(f'{e:.3g}') for e in nudged[0]]}, leaves up to "
              f"{max(nudged[1].values()):.3e}, flips {nudged[2]}")
        lines.append(f"replica {r}: history and all {len(copy_r[1])} weight leaves of the "
                     f"float32 run equal a stack of eight copies of member {r} bit for bit; in "
                     f"float64 vs the serial run over {CLI_EPOCHS} epochs rows "
                     f"{rows.max():.3e}, kernels {max(kernels.values()):.3e} (tol {SWEEP_TOL}), "
                     f"biases {max(biases.values()):.3e} (tol {SWEEP_BIAS_TOL}), flips "
                     f"{max(flips)} (limit {SWEEP_FLIPS})")
    return "; ".join(lines)


class CrashAt:
    """A hook that raises at ``epoch``, as a process killed mid-run."""

    class Crash(Exception):
        pass

    def __init__(self, epoch):
        self.epoch = epoch

    def __call__(self, sweep, states, epoch):
        if epoch == self.epoch:
            raise CrashAt.Crash(f"crash at epoch {epoch}")


def resume_amorphous_sweep(tmp, sweep_run):
    """``run_amorphous_sweep(checkpoint_dir=)`` at phase 9's configuration and
    cuts, with the MI hook persisting its records: a hook raises at epoch 4,
    after the first chunk's checkpoint (epoch 2); the relaunch resumes from
    it, and its records, its weights and the MI bounds it measures again at
    epoch 4 equal phase 9's uninterrupted run bit for bit."""
    from dib_tpu_torch.parallel import SweepInfoPerFeatureHook
    from dib_tpu_torch.train.checkpoint import DIBCheckpointer

    config, want, want_hook = sweep_run["config"], sweep_run["result"], sweep_run["hook"]
    ckpt, persist = os.path.join(tmp, "sweep_ckpt"), os.path.join(tmp, "sweep_bounds")
    hook = SweepInfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches, seed=SEED,
                                   persist=persist)
    try:
        run_sweep(config, [hook, CrashAt(SWEEP_EPOCHS)], {"use_flash": True},
                  checkpoint_dir=ckpt)
        fail("amorphous sweep: the crashing hook did not stop the run")
    except CrashAt.Crash:
        pass
    if DIBCheckpointer(ckpt).all_steps() != [SWEEP_CHUNK]:
        fail(f"amorphous sweep: steps {DIBCheckpointer(ckpt).all_steps()} after the crash, "
             f"expected [{SWEEP_CHUNK}]")
    hook = SweepInfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches, seed=SEED,
                                   persist=persist, resume=True)
    result, groups, launches, _ = run_sweep(config, [hook], {"use_flash": True},
                                            checkpoint_dir=ckpt)
    steps = (SWEEP_EPOCHS - SWEEP_CHUNK) * SWEEP_STEPS_PER_EPOCH
    blocks = len(result["states"].params["model"].aggregator.blocks)
    print(f"main path launches (amorphous sweep resumed at epoch {result['resumed_from_epoch']}, "
          f"{steps} steps, {SWEEP_EPOCHS - SWEEP_CHUNK} validation passes, 1 MI hook call): "
          f"{json.dumps(launches)}")
    if result["resumed_from_epoch"] != SWEEP_CHUNK or \
            launches["flash_attention"] != blocks * (steps + SWEEP_EPOCHS - SWEEP_CHUNK) or \
            launches["mi_row_stats"] != config.mi_eval_batches:
        fail(f"amorphous sweep: resumed from {result['resumed_from_epoch']} with launches "
             f"{launches}")
    for r, (got, w) in enumerate(zip(result["records"], want["records"])):
        for name in ("beta", "kl_per_feature", "loss", "val_loss", "metric", "val_metric"):
            if not np.array_equal(getattr(got, name), getattr(w, name)):
                fail(f"amorphous sweep: replica {r}'s {name} differs from the uninterrupted "
                     f"run's")
    want_params = want["states"].params.state_dict()
    for name, value in result["states"].params.state_dict().items():
        if not torch.equal(value, want_params[name]):
            fail(f"amorphous sweep: weight {name} differs from the uninterrupted run's")
    if list(hook.epochs) != list(want_hook.epochs) or not all(
            np.array_equal(g["bounds"], w["bounds"])
            for g, w in zip(hook.records, want_hook.records)):
        fail("amorphous sweep: the MI bounds measured again differ from the uninterrupted "
             "run's")
    print(f"amorphous sweep: crashed at epoch {SWEEP_EPOCHS} after the checkpoint at epoch "
          f"{SWEEP_CHUNK}; resumed from epoch {result['resumed_from_epoch']}; every record, all "
          f"{len(want_params)} weight leaves and the MI bounds at epochs "
          f"{hook.epochs.tolist()} (epoch {SWEEP_EPOCHS} measured again) equal phase 9's "
          f"uninterrupted run bit for bit")
    return launches


def serve_checkpoint(serial):
    """``InferenceEngine.from_checkpoint`` on the CLI run's directory, into a
    model built from another seed, against the trained weights read
    straight from the final step's leaves: SERVE_TOL."""
    from dib_tpu_torch import cli
    from dib_tpu_torch.serve import InferenceEngine
    from dib_tpu_torch.train import DIBTrainer

    args = cli.build_parser().parse_args(cli_argv(serial["whole"], serial["whole_ckpt"]))
    bundle = cli._bundle_from_args(args)
    trained, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE)
    trained.load_state_dict({name[len("params/model."):]: torch.from_numpy(value)
                             for name, value in checkpoint_leaves(serial["whole_ckpt"],
                                                                  CLI_EPOCHS).items()
                             if name.startswith("params/")})
    args.seed += 1
    fresh, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE)
    engine = InferenceEngine.from_checkpoint(
        DIBTrainer(fresh, bundle, cli._train_config(args), device=CLI_DEVICE),
        serial["whole_ckpt"])
    x = bundle.x_valid
    served = engine.predict(x)["prediction"]
    with torch.inference_mode():
        want, _ = trained(torch.as_tensor(x, device=CLI_DEVICE), sample=False)
    return compare(f"from_checkpoint predict vs the trained model, {len(x)} rows",
                   [torch.from_numpy(served)], [want.cpu()], SERVE_TOL)


def quarantine_corrupt_step(tmp, serial):
    """One byte flipped in the newest step: it lands in ``quarantine/`` and
    the step before it is restored."""
    from dib_tpu_torch import cli
    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.train.checkpoint import DIBCheckpointer

    directory = os.path.join(tmp, "corrupt_ckpt")
    shutil.copytree(serial["whole_ckpt"], directory)
    path = os.path.join(directory, str(CLI_EPOCHS), "leaves.npz")
    with open(path, "rb+") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))
    args = cli.build_parser().parse_args(cli_argv(tmp, directory))
    bundle = cli._bundle_from_args(args)
    model, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE)
    ckpt = DIBCheckpointer(directory)
    reports = []
    state, _, _ = ckpt.restore_latest_intact(
        DIBTrainer(model, bundle, cli._train_config(args), device=CLI_DEVICE),
        chunk_size=CLI_CADENCE, on_fallback=reports.append)
    moved = os.path.join(directory, "quarantine", str(CLI_EPOCHS))
    if state.epoch != CLI_EPOCHS - CLI_CADENCE or ckpt.fallback_skipped_steps != [CLI_EPOCHS] \
            or not os.path.isfile(os.path.join(moved, "leaves.npz")) or \
            CLI_EPOCHS in ckpt.all_steps():
        fail(f"corrupt step: restored epoch {state.epoch}, skipped "
             f"{ckpt.fallback_skipped_steps}, steps {ckpt.all_steps()}")
    print(f"corrupt step: one byte flipped in step {CLI_EPOCHS}: moved to {moved} "
          f"({reports[0]['error'][:120]}...); step {state.epoch} restored")


def time_checkpoints(card, tmp, sweep_run, serial_ckpt):
    """Save and restore of the north star's stacked state (phase 9's: 8 x
    1,293,505 parameters, Adam's two moments, the history, 8 generators)
    and of the CLI's serial state, host clock, median of 3."""
    from dib_tpu_torch import cli
    from dib_tpu_torch.parallel import BetaSweepTrainer, member_seed
    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.train.checkpoint import DIBCheckpointer

    config, bundle, result = sweep_run["config"], sweep_run["bundle"], sweep_run["result"]
    states = result["states"]
    sweep = BetaSweepTrainer(states.params["model"], bundle,
                             config.train_config(SWEEP_STEPS_PER_EPOCH), config.beta_start,
                             result["beta_ends"], device=CLI_DEVICE)
    _, histories = sweep.init()
    generators = [torch.Generator(device=CLI_DEVICE).manual_seed(member_seed(SEED, r))
                  for r in range(len(result["beta_ends"]))]
    args = cli.build_parser().parse_args(cli_argv(tmp, tmp))
    cli_bundle = cli._bundle_from_args(args)
    model, _ = cli._model_from_args(args, cli_bundle, device=CLI_DEVICE)
    trainer = DIBTrainer(model, cli_bundle, cli._train_config(args), device=CLI_DEVICE)
    serial_state, serial_history, _ = DIBCheckpointer(serial_ckpt).restore(trainer)
    rows = {}
    for label, owner, state, history, gens in (
            ("north star sweep state", sweep, states, histories, generators),
            ("CLI serial state", trainer, serial_state, serial_history,
             torch.Generator(device=CLI_DEVICE).manual_seed(SEED))):
        ckpt = DIBCheckpointer(os.path.join(tmp, f"timed_{len(rows)}"), max_to_keep=1)
        save, restore = [], []
        for step in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ckpt.save(step + 1, state, history, gens, chunk_size=SWEEP_CHUNK)
            save.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            ckpt.restore(owner)
            torch.cuda.synchronize()
            restore.append((time.perf_counter() - t0) * 1e3)
        nbytes = os.path.getsize(os.path.join(path, "leaves.npz"))
        n_params = sum(p.numel() for p in state.params.parameters())
        rows[label] = (statistics.median(save), statistics.median(restore), nbytes)
        print(f"timing [{card}] checkpoint of the {label} ({n_params} parameters, "
              f"{nbytes / 1e6:.3f} MB of leaves): save {rows[label][0]:.4f} ms, restore "
              f"{rows[label][1]:.4f} ms (host clock, median of 3, fsync included, warm page "
              f"cache)")
    return rows


def time_boolean_steps(card):
    """The boolean flagship's training step at the CLI defaults, serial and
    as the CLI's 8-replica sweep, in turns."""
    from dib_tpu_torch import cli
    from dib_tpu_torch.parallel import BetaSweepTrainer
    from dib_tpu_torch.train import DIBTrainer

    args = cli.build_parser().parse_args(cli_argv("unused", "unused", *CLI_SWEEP))
    bundle = cli._bundle_from_args(args)
    config = cli._train_config(args)
    model, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE)
    serial = DIBTrainer(model, bundle, config, device=CLI_DEVICE)
    stacked, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE, replicas=8)
    ends = np.repeat(np.asarray(args.sweep_beta_ends), args.sweep_repeats)
    sweep = BetaSweepTrainer(stacked, bundle, config, args.beta_start, ends, device=CLI_DEVICE)
    gen = torch.Generator(device=CLI_DEVICE).manual_seed(SEED + 13)
    x_all = torch.as_tensor(bundle.x_train, device=CLI_DEVICE)
    y_all = torch.as_tensor(bundle.y_train, device=CLI_DEVICE)
    inputs = {}
    for name, trainer, lead in (("serial", serial, ()), ("8 replicas", sweep, (8,))):
        rows = torch.randint(0, len(x_all), lead + (args.batch_size,), generator=gen,
                             device=CLI_DEVICE)
        eps = torch.randn(trainer.model.noise_shape(args.batch_size), generator=gen,
                          device=CLI_DEVICE)
        beta = trainer._betas(0, 1)[0]
        state, _ = trainer.init()
        inputs[name] = (trainer, state, x_all[rows], y_all[rows], beta, eps)
    fns = {name: (lambda t=t, s=s, x=x, y=y, b=b, e=e: t.train_step(s, x, y, b, e))
           for name, (t, s, x, y, b, e) in inputs.items()}
    ms = host_ms(fns)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"timing [{card}] boolean flagship training step ({n_params} parameters, batch "
          f"{args.batch_size}): serial {ms['serial']:.4f} ms, 8 replicas {ms['8 replicas']:.4f} "
          f"ms beside 8 x serial {8 * ms['serial']:.4f} ms (host clock, median of 10 in turns)")
    for name, fn in fns.items():
        print(f"profile [{card}] boolean training step ({name}): "
              f"{profile_breakdown(fn, top=6, unprofiled_ms=ms[name])}")
    return ms


def drive_cli(card, sweep_run, tmp):
    """Phase 12, in the directory ``tmp``: (a) the serial CLI with a resume,
    (b) the README's sweep command with a resume and replicas 0 and 7 held to
    serial runs, (c) the amorphous sweep driver with a resume, (d) serving a
    checkpoint, (e) a corrupt step, (f) timings. Phase 13 serves (a)'s and
    (b)'s checkpoints."""
    from dib_tpu_torch import cli

    args = cli.build_parser().parse_args(cli_argv("unused", "unused"))
    bundle = cli._bundle_from_args(args)
    model, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != CLI_PARAMS or len(bundle.x_train) // args.batch_size != 8:
        fail(f"CLI: {n_params} parameters, {len(bundle.x_train)} rows; expected {CLI_PARAMS} "
             f"and 8 steps of {args.batch_size}")
    print(f"CLI: python -m dib_tpu_torch train at its defaults (boolean_circuit, "
          f"DistributedIBModel of {n_params} parameters, batch {args.batch_size}, 8 steps per "
          f"epoch, MI hook 1024 x 8); cut: {' '.join(CLI_CUTS)}")
    serial = cli_resume("serial", tmp, [], ["history.npz"], 3)
    with np.load(os.path.join(tmp, "serial_run", "info_bounds.npz")) as bounds:
        if bounds["epochs"].tolist() != [4, 8, 12] or \
                int(bounds["resumed_from_epoch"]) != serial["resumed_from"] or \
                not np.isfinite(bounds["bounds_bits"]).all():
            fail(f"CLI serial: the resumed run's info_bounds.npz holds epochs "
                 f"{bounds['epochs'].tolist()} spliced at {int(bounds['resumed_from_epoch'])}"
                 f", expected [4, 8, 12] spliced at {serial['resumed_from']}")
    sweep = cli_resume("sweep", tmp, CLI_SWEEP,
                       [f"history_replica{r}.npz" for r in range(8)], 3 * 8)
    for r in range(8):
        with np.load(os.path.join(sweep["whole"], f"history_replica{r}.npz")) as hist:
            if any(not np.isfinite(hist[k]).all() for k in hist.files):
                fail(f"CLI sweep: replica {r} is not finite")
    print(f"CLI sweep: 8 replicas, endpoints {sweep['summary']['beta_ends']}, all finite; "
          f"{hold_cli_replicas(tmp, sweep)}")
    amorphous_launches = resume_amorphous_sweep(tmp, sweep_run)
    serve_err = serve_checkpoint(serial)
    quarantine_corrupt_step(tmp, serial)
    for label, run in (("serial", serial), ("sweep", sweep)):
        print(f"timing [{card}] CLI {label} wall (host clock, s): " + json.dumps(
            {k: round(v, 3) for k, v in run["wall_s"].items()}))
    checkpoint_ms = time_checkpoints(card, tmp, sweep_run, serial["whole_ckpt"])
    step_ms = time_boolean_steps(card)
    launches = {name: serial["launches"][name] + sweep["launches"][name] +
                amorphous_launches[name] for name in serial["launches"]}
    return dict(launches=launches, serve_err=serve_err, checkpoint_ms=checkpoint_ms,
                step_ms=step_ms, serial_ckpt=serial["whole_ckpt"],
                sweep_ckpt=sweep["whole_ckpt"], serial_dir=serial["whole"],
                sweep_dir=sweep["whole"])


# --------------------------------------------------------------------------
# phase 13: main path 8, HTTP serving

HELLO_TIMEOUT = 180          # seconds for a serve process to print its hello line
HTTP_REQUESTS = 200          # concurrent requests held to the direct engine
HTTP_MAX_ROWS = 300          # past the top bucket (128): chunked dispatch
HTTP_CONCURRENCY = 32
# the sweep process: per-tenant quota (rate, burst), admission limit, cache size
QUOTA = ("1", "2")
ADMISSION_LIMIT = "2"
RESPONSE_CACHE = "64"
# β values routed over the CLI sweep's endpoints (0.03, 0.1, 0.3, 1.0, two
# members each): on, between and beyond them
SWEEP_BETAS = (0.01, 0.03, 0.05, 0.1, 0.17, 0.3, 0.55, 1.0, 3.0)
# closed-loop timing: requests per round at each concurrency, two rounds
TIMING_REQUESTS = {1: 200, HTTP_CONCURRENCY: 640}


class ServeProcess:
    """``python -m dib_tpu_torch serve ...`` in a process of its own: its
    hello line, its stderr in a temporary file, SIGTERM."""

    def __init__(self, label, argv):
        import tempfile

        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.label = label
        self.err = tempfile.TemporaryFile("w+")
        # a session of its own: kill() takes its pool and prefork children too
        self.proc = subprocess.Popen([*CLI_COMMAND, "serve", *argv], cwd=ROOT, env=env,
                                     text=True, stdout=subprocess.PIPE, stderr=self.err,
                                     start_new_session=True)
        self.hello = None

    def stderr_tail(self) -> str:
        self.err.seek(0)
        return self.err.read()[-3000:]

    def wait_hello(self) -> dict:
        import select

        end = time.monotonic() + HELLO_TIMEOUT
        while self.hello is None:
            if self.proc.poll() is not None or time.monotonic() > end:
                fail(f"serve {self.label}: no hello line (exit {self.proc.poll()})\n"
                     f"{self.stderr_tail()}")
            if select.select([self.proc.stdout], [], [], 0.5)[0]:
                line = self.proc.stdout.readline()
                try:
                    self.hello = json.loads(line)
                except ValueError:
                    fail(f"serve {self.label}: the first line is not the hello: {line!r}\n"
                         f"{self.stderr_tail()}")
        return self.hello

    @property
    def url(self) -> str:
        return self.hello["serving"]

    def stop(self) -> tuple[int, list]:
        """SIGTERM; (exit code, the JSON lines printed after the hello)."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            out, _ = self.proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"serve {self.label}: SIGTERM did not stop it in 120 s")
        return self.proc.returncode, [json.loads(line) for line in out.splitlines()
                                      if line.startswith("{")]

    def kill(self):
        """SIGKILL the process and every process of its session."""
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


def http_call(url, path, body=None, headers=None):
    """(status, headers, body bytes) of one request on a fresh connection."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(request, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def http_json(url, path, body=None, headers=None):
    status, _, raw = http_call(url, path, body, headers)
    return status, json.loads(raw)


def parallel_calls(fns, workers=HTTP_CONCURRENCY):
    """Run the callables from ``workers`` threads; their results in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda fn: fn(), fns))


def hold_served(label, payload, want, n):
    """Each array of a served payload against the direct engine's: shape and
    SERVE_TOL; returns the largest error."""
    worst = 0.0
    for key, value in want.items():
        got = np.asarray(payload[key], np.float32)
        if got.shape != value.shape or got.shape[0] != n or not np.isfinite(got).all():
            fail(f"{label}: {key} of shape {got.shape}, expected {value.shape} finite")
        err = np.abs(got - value)
        if not (err <= SERVE_TOL + SERVE_TOL * np.abs(value)).all():
            fail(f"{label}: {key} differs from the direct engine by {err.max():.3e}")
        worst = max(worst, float(err.max()))
    return worst


# one load-generating process: reads the request body, opens its keep-alive
# connections, prints "ready", waits for "go", sends its requests back to
# back from its threads and prints the latencies (s) and statuses as JSON
LOAD_CLIENT = r"""
import http.client, json, sys, threading, time
from urllib.parse import urlparse
url, threads, per_thread = urlparse(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
body = sys.stdin.readline().encode()
conns = [http.client.HTTPConnection(url.hostname, url.port, timeout=120) for _ in range(threads)]
out = [[] for _ in range(threads)]
def client(k):
    for _ in range(per_thread):
        t0 = time.perf_counter()
        conns[k].request("POST", "/v1/predict", body, {"Content-Type": "application/json"})
        resp = conns[k].getresponse()
        resp.read()
        out[k].append((time.perf_counter() - t0, resp.status))
workers = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
print("ready", flush=True)
sys.stdin.readline()
for t in workers:
    t.start()
for t in workers:
    t.join()
print(json.dumps([x for per in out for x in per]), flush=True)
"""
LOAD_THREADS = 8             # threads per load-generating process


def closed_loop(url, rows, concurrency, requests):
    """``requests`` predicts of ``rows`` at closed-loop ``concurrency``:
    ceil(concurrency / LOAD_THREADS) client processes of their own (one
    Python client process caps near a thousand requests per second), each
    thread on its own keep-alive connection, started together: (latencies
    in s, wall s). Fails on any status but 200."""
    procs_n = max(1, -(-concurrency // LOAD_THREADS))
    threads = concurrency // procs_n
    per_thread = requests // (procs_n * threads)
    body = json.dumps({"x": rows.tolist()}) + "\n"
    clients = [subprocess.Popen([sys.executable, "-c", LOAD_CLIENT, url, str(threads),
                                 str(per_thread)], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True) for _ in range(procs_n)]
    try:
        for client in clients:
            client.stdin.write(body)
            client.stdin.flush()
        for client in clients:
            if client.stdout.readline().strip() != "ready":
                fail(f"closed loop on {url}: a load client did not start")
        t0 = time.perf_counter()
        for client in clients:
            client.stdin.write("go\n")
            client.stdin.flush()
        answers = [json.loads(client.stdout.readline()) for client in clients]
        wall = time.perf_counter() - t0
    finally:
        for client in clients:
            client.kill()
            client.wait()
    answers = [a for per in answers for a in per]
    statuses = {status for _, status in answers}
    if statuses != {200} or len(answers) != procs_n * threads * per_thread:
        fail(f"closed loop on {url}: statuses {sorted(statuses)}, {len(answers)} answers")
    return [seconds for seconds, _ in answers], wall


def quantiles_ms(seconds) -> dict:
    ordered = sorted(seconds)
    pick = lambda q: ordered[min(int(q * len(ordered)), len(ordered) - 1)] * 1e3
    return {"p50": round(pick(0.5), 4), "p99": round(pick(0.99), 4), "n": len(ordered)}


def pool_worker_pids(pid) -> list[int]:
    """The engine-subprocess workers of serve process ``pid``: its children
    started by multiprocessing's spawn (not its resource tracker)."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if ppid == pid and b"spawn_main" in cmdline:
            found.append(int(entry))
    return sorted(found)


def serve_direct_engines(serial_ckpt, sweep_ckpt):
    """The direct engines phase 13 holds the servers to: the serial
    checkpoint through ``InferenceEngine.from_checkpoint``, and each member
    of the sweep checkpoint carved out of the restored stack."""
    from dib_tpu_torch import cli
    from dib_tpu_torch.parallel import BetaSweepTrainer
    from dib_tpu_torch.serve import InferenceEngine
    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.train.checkpoint import DIBCheckpointer

    args = cli.serve_parser().parse_args(["--checkpoint_dir", serial_ckpt])
    bundle = cli._bundle_from_args(args)
    model, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE)
    serial = InferenceEngine.from_checkpoint(
        DIBTrainer(model, bundle, cli._serve_config(args), device=CLI_DEVICE), serial_ckpt)
    args = cli.serve_parser().parse_args(["--checkpoint_dir", sweep_ckpt, *CLI_SWEEP])
    ends = np.repeat(np.asarray(args.sweep_beta_ends, np.float64), args.sweep_repeats)
    stacked, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE, replicas=len(ends))
    sweep = BetaSweepTrainer(stacked, bundle, cli._serve_config(args), args.beta_start, ends,
                             device=CLI_DEVICE)
    states, _, _ = DIBCheckpointer(sweep_ckpt).restore(sweep)
    members = [InferenceEngine(states.params["model"].carve(r), device=CLI_DEVICE)
               for r in range(len(ends))]
    return serial, members, ends, np.asarray(bundle.x_valid, np.float32)


def check_serial_server(server, direct, x):
    """200 concurrent predicts and encodes of 1 to 300 rows held to the
    direct engine; the error map; the GET routes. Returns the number of
    requests that went through the batcher."""
    rng = np.random.default_rng(SEED)
    jobs = []
    for i in range(HTTP_REQUESTS):
        rows = x[rng.integers(0, len(x), size=int(rng.integers(1, HTTP_MAX_ROWS + 1)))]
        op = ("predict", "encode")[i % 2]
        jobs.append((op, rows))
    answers = parallel_calls([lambda op=op, rows=rows: http_json(
        server.url, f"/v1/{op}", {"x": rows.tolist()}) for op, rows in jobs])
    worst = 0.0
    for i, ((op, rows), (status, payload)) in enumerate(zip(jobs, answers)):
        if status != 200:
            fail(f"HTTP serial: request {i} ({op}, {len(rows)} rows) gave {status}: {payload}")
        worst = max(worst, hold_served(f"HTTP serial request {i} ({op}, {len(rows)} rows)",
                                       payload, getattr(direct, op)(rows), len(rows)))
    over_top = sum(len(rows) > direct.max_bucket for _, rows in jobs)
    width = x.shape[1]
    cases = [("wrong width", "/v1/predict", {"x": [[0.0] * (width + 1)]}, 400),
             ("non-finite", "/v1/predict", {"x": [[float("nan")] * width]}, 400),
             ("unknown model", "/v1/predict", {"x": x[:1].tolist(), "model": "nope"}, 404),
             ("unknown route", "/v1/nope", {"x": x[:1].tolist()}, 404)]
    for label, path, body, want in cases:
        status, payload = http_json(server.url, path, body)
        if status != want or "error" not in payload:
            fail(f"HTTP serial: {label} gave {status} {payload}, expected {want}")
    status, health = http_json(server.url, "/healthz")
    status_models, models = http_json(server.url, "/v1/models")
    status_metrics, metrics = http_json(server.url, "/metrics")
    prom_status, prom_headers, prom = http_call(server.url, "/metrics",
                                                headers={"Accept": "text/plain"})
    if status != 200 or health["status"] != "ok" or health["feature_width"] != width or \
            health["healthy_replicas"] != torch.cuda.device_count():
        fail(f"HTTP serial: /healthz gave {status} {health}")
    if status_models != 200 or [m["model"] for m in models["models"]] != ["default"]:
        fail(f"HTTP serial: /v1/models gave {status_models} {models}")
    if status_metrics != 200 or metrics["counters"].get("serve.requests.ok") != HTTP_REQUESTS:
        fail(f"HTTP serial: /metrics counters {metrics.get('counters')}")
    if prom_status != 200 or not prom_headers.get("Content-Type", "").startswith("text/plain") \
            or b"# TYPE dib_serve_requests_ok counter" not in prom:
        fail(f"HTTP serial: Prometheus /metrics gave {prom_status} {prom[:200]!r}")
    print(f"HTTP serial: {HTTP_REQUESTS} concurrent predict/encode requests of 1-{HTTP_MAX_ROWS} "
          f"rows ({over_top} past the top bucket {direct.max_bucket}) from {HTTP_CONCURRENCY} "
          f"threads, each held to InferenceEngine.from_checkpoint: max_abs_err={worst:.3e} "
          f"tol={SERVE_TOL}; wrong width 400, non-finite 400, unknown model 404, unknown route "
          f"404; /healthz {health['healthy_replicas']} healthy on {health['replicas'][0]['device']}"
          f", /v1/models, /metrics as JSON and Prometheus text")
    return HTTP_REQUESTS, sum(len(rows) for _, rows in jobs), worst


def check_sweep_server(server, members, ends, x):
    """β routing to the nearest endpoint in log-β, each answer held to the
    chosen member's carved engine; then quota (429), admission (503) and the
    response cache on the same process."""
    rows = x[:5]
    worst, chosen = 0.0, []
    for i, beta in enumerate(SWEEP_BETAS):
        want = int(np.argmin(np.abs(np.log(ends) - math.log(beta))))    # first of ties
        status, payload = http_json(server.url, "/v1/predict",
                                    {"x": rows.tolist(), "beta": beta, "tenant": f"beta{i}"})
        if status != 200 or payload["replica"]["replica"] != want or \
                payload["replica"]["beta_end"] != float(ends[want]):
            fail(f"HTTP sweep: beta {beta} gave {status} {payload.get('replica')}, expected "
                 f"member {want} (beta_end {ends[want]})")
        worst = max(worst, hold_served(f"HTTP sweep beta {beta}", payload,
                                       members[want].predict(rows), len(rows)))
        chosen.append(want)
    # quota: tenant "greedy" has a burst of QUOTA[1]
    quota = [http_call(server.url, "/v1/predict", {"x": rows[:1].tolist()},
                       {"X-DIB-Tenant": "greedy"}) for _ in range(4)]
    codes = [q[0] for q in quota]
    limited = [q for q in quota if q[0] == 429]
    if codes[:2] != [200, 200] or not limited or any(
            int(q[1].get("Retry-After", 0)) < 1 for q in limited):
        fail(f"HTTP sweep: the greedy tenant's statuses {codes}; expected 200, 200, then 429 "
             f"with Retry-After")
    # admission: concurrent 300-row requests to one member, each its own tenant
    big = x[:HTTP_MAX_ROWS].tolist()
    shed = parallel_calls([lambda i=i: http_call(server.url, "/v1/predict", {
        "x": big, "beta": 1.0, "tenant": f"shed{i}"}) for i in range(64)], workers=64)
    shed_codes = sorted({s[0] for s in shed})
    if 503 not in shed_codes or set(shed_codes) - {200, 503} or any(
            "Retry-After" not in s[1] for s in shed if s[0] == 503):
        fail(f"HTTP sweep: 64 concurrent requests with admission limit {ADMISSION_LIMIT} gave "
             f"statuses {shed_codes}; expected some 503 with Retry-After")
    n_shed = sum(s[0] == 503 for s in shed)
    # the response cache: a query not sent before, twice
    body = {"x": x[5:10].tolist(), "beta": 0.2}
    first = http_json(server.url, "/v1/predict", {**body, "tenant": "cache1"})
    again = http_json(server.url, "/v1/predict", {**body, "tenant": "cache2"})
    if first[0] != 200 or again[0] != 200 or "cached" in first[1] or \
            again[1].get("cached") is not True or again[1]["prediction"] != first[1]["prediction"]:
        fail(f"HTTP sweep: the repeated query was not a cache hit: {again}")
    print(f"HTTP sweep: {len(ends)} members, endpoints {ends.tolist()}; beta "
          f"{list(SWEEP_BETAS)} routed to members {chosen} (nearest in log-beta), each answer "
          f"held to its member's carved engine: max_abs_err={worst:.3e} tol={SERVE_TOL}; "
          f"--quota_rps {QUOTA[0]} --quota_burst {QUOTA[1]}: a tenant's statuses {codes} "
          f"(Retry-After {limited[0][1]['Retry-After']}); --admission_limit {ADMISSION_LIMIT}: "
          f"{n_shed} of 64 concurrent requests shed with 503 + Retry-After; --response_cache "
          f"{RESPONSE_CACHE}: the repeated query answered with cached: true")
    return worst


def check_pool_server(server, direct, x):
    """--workers 2 on the card: SIGKILL one worker mid-service, every call
    still 200 and held to the direct engine; the probe respawns it."""
    import signal

    pids = pool_worker_pids(server.proc.pid)
    if len(pids) != 2:
        fail(f"HTTP workers: found worker pids {pids}, expected 2")
    rng = np.random.default_rng(SEED + 1)
    jobs = [x[rng.integers(0, len(x), size=int(rng.integers(1, 9)))] for _ in range(240)]
    done = []

    def job(rows):
        answer = http_json(server.url, "/v1/predict", {"x": rows.tolist()})
        done.append(1)
        return answer

    def killer():
        while len(done) < 40:
            time.sleep(0.001)
        os.kill(pids[0], signal.SIGKILL)
        return len(done)

    t0 = time.monotonic()
    answers = parallel_calls([killer] + [lambda rows=rows: job(rows) for rows in jobs],
                             workers=9)
    killed_after, answers = answers[0], answers[1:]
    for i, (rows, (status, payload)) in enumerate(zip(jobs, answers)):
        if status != 200:
            fail(f"HTTP workers: request {i} after the kill gave {status}: {payload}")
        hold_served(f"HTTP workers request {i}", payload, direct.predict(rows), len(rows))
    end = time.monotonic() + 150
    while time.monotonic() < end:
        health = http_json(server.url, "/healthz")[1]
        now = pool_worker_pids(server.proc.pid)
        if health["healthy_replicas"] == 2 and len(now) == 2 and pids[0] not in now:
            break
        time.sleep(0.5)
    else:
        fail(f"HTTP workers: the killed worker was not respawned and re-admitted: {health}, "
             f"workers {pool_worker_pids(server.proc.pid)}")
    print(f"HTTP workers: --workers 2 on {health['replicas'][0].get('device')}, worker pid "
          f"{pids[0]} SIGKILLed after {killed_after} of {len(jobs)} requests from 8 threads: "
          f"all {len(jobs)} answered 200, each held to the direct engine (tol {SERVE_TOL}); "
          f"the probe respawned it as pid {sorted(set(now) - set(pids))} and re-admitted it "
          f"{time.monotonic() - t0:.1f} s after the traffic began")
    return len(jobs)


def check_prefork_server(server, card):
    """--prefork 2: both worker pids serve traffic, and ``serve top --once``
    renders the fleet."""
    pids = sorted(server.hello["workers"])
    x = np.zeros((1, 10), np.float32).tolist()
    for _ in range(64):
        if http_json(server.url, "/v1/predict", {"x": x})[0] != 200:
            fail("HTTP prefork: a predict did not answer 200")
    served = {}
    for _ in range(200):
        snapshot = http_json(server.url, "/metrics")[1]
        served[snapshot["pid"]] = snapshot["counters"].get("serve.requests.ok", 0)
        if len(served) == 2:
            break
    if sorted(served) != pids or not all(served.values()):
        fail(f"HTTP prefork: requests served per pid {served}, expected both of {pids}")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    top = subprocess.run([*CLI_COMMAND, "serve", "top", "--url", server.url, "--workers", "2",
                          "--once"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    if top.returncode != 0 or "2/2 worker(s) seen" not in top.stdout:
        fail(f"HTTP prefork: serve top gave {top.returncode}:\n{top.stdout}\n{top.stderr}")
    print(f"HTTP prefork: --prefork 2, worker pids {pids} served {served} of 64 predicts "
          f"(kernel-balanced connections); serve top --once:\n{top.stdout.rstrip()}")


def served_launches(procs) -> dict:
    """The kernel launch counts that the serving processes publish on
    ``/metrics``, read before SIGTERM and summed: the single process, the
    sweep's, the pool's front process, the one without a stream and both
    prefork workers (each pid
    through ``serve top``'s scrape). Each process starts with every count
    at 0. The pool's two engine subprocesses publish nothing and are not
    read."""
    from dib_tpu_torch.serve.top import scrape_fleet

    per_process = {}
    for label in ("serial", "sweep", "workers", "quiet"):
        snapshot = http_json(procs[label].url, "/metrics")[1]
        per_process[f"{label} pid {snapshot['pid']}"] = snapshot["kernel_launches"]
    fleet = scrape_fleet(procs["prefork"].url, 2, timeout_s=30.0)
    if sorted(fleet) != sorted(procs["prefork"].hello["workers"]):
        fail(f"HTTP prefork: /metrics reached pids {sorted(fleet)}, expected "
             f"{sorted(procs['prefork'].hello['workers'])}")
    for pid, snapshot in fleet.items():
        per_process[f"prefork pid {pid}"] = snapshot["kernel_launches"]
    total = {name: sum(counts[name] for counts in per_process.values())
             for name in next(iter(per_process.values()))}
    print(f"main path launches (HTTP serving, read from /metrics of the {len(per_process)} "
          f"serving processes; the pool's engine subprocesses are not read): "
          f"{json.dumps(total)}; per process: {json.dumps(per_process)}")
    return total


def time_http(card, procs, direct, x):
    """Host-clock timings of the HTTP plane, in turns: requests per second
    at closed-loop concurrency 32 (1 row) for 1 process, --prefork 2 and
    --workers 2; request latency p50/p99 for 1 and 8 rows at concurrency 1
    and 32 on the single process, beside the direct ``engine.predict``.
    The serving processes write their event stream (the default
    ``--telemetry-dir``), so these figures include its cost. Returns (the
    figures, the requests and the rows sent to the single process)."""
    rates = {name: [] for name in ("1 process", "prefork 2", "workers 2")}
    urls = {"1 process": procs["serial"].url, "prefork 2": procs["prefork"].url,
            "workers 2": procs["workers"].url}
    latency = {}
    sent = sent_rows = 0
    for turn in (0, 1):
        order = list(rates) if turn == 0 else list(rates)[::-1]
        for name in order:
            n = TIMING_REQUESTS[HTTP_CONCURRENCY]
            seconds, wall = closed_loop(urls[name], x[:1], HTTP_CONCURRENCY, n)
            rates[name].append(len(seconds) / wall)
            if name == "1 process":
                sent, sent_rows = sent + len(seconds), sent_rows + len(seconds)
        for rows in (1, 8):
            for conc in (1, HTTP_CONCURRENCY):
                seconds, _ = closed_loop(urls["1 process"], x[:rows], conc,
                                         TIMING_REQUESTS[conc])
                latency.setdefault(f"{rows} row(s), concurrency {conc}", []).extend(seconds)
                sent, sent_rows = sent + len(seconds), sent_rows + rows * len(seconds)
    direct_s = {}
    for rows in (1, 8):
        direct.predict(x[:rows])
        calls = []
        for _ in range(200):
            t0 = time.perf_counter()
            direct.predict(x[:rows])
            calls.append(time.perf_counter() - t0)
        direct_s[f"{rows} row(s)"] = quantiles_ms(calls)
    figures = {
        "requests_per_s": {k: [round(v, 1) for v in vals] for k, vals in rates.items()},
        "latency_ms": {k: quantiles_ms(v) for k, v in latency.items()},
        "direct_predict_ms": direct_s,
    }
    print(f"timing [{card}] HTTP serving (host clock, closed loop, keep-alive connections "
          f"from {LOAD_THREADS} threads per client process; two rounds in turns; every serving "
          f"process writes its event stream, the default --telemetry-dir): "
          + json.dumps(figures))
    return figures, sent, sent_rows


def time_stream_cost(card, procs, x):
    """The event stream's price per request: ``POST /v1/predict`` latency
    p50/p99 with 1 row at concurrency 1 and 32, on the single process (the
    default stream) and on one started with ``--telemetry-dir ''``, two
    rounds in turns (off, on, then on, off). Returns (the figures, the
    requests sent to the single process)."""
    latency, sent = {}, 0
    for turn in (0, 1):
        order = ("off", "on") if turn == 0 else ("on", "off")
        for conc in (1, HTTP_CONCURRENCY):
            for stream in order:
                proc = procs["serial" if stream == "on" else "quiet"]
                seconds, _ = closed_loop(proc.url, x[:1], conc, TIMING_REQUESTS[conc])
                latency.setdefault(f"stream {stream}, concurrency {conc}", []).extend(seconds)
                sent += len(seconds) if stream == "on" else 0
    figures = {k: quantiles_ms(v) for k, v in latency.items()}
    print(f"stream cost [{card}] POST /v1/predict, 1 row, latency ms with the default event "
          f"stream (on) and --telemetry-dir '' (off), host clock, closed loop, two rounds in "
          f"turns: " + json.dumps(figures))
    return figures, sent


def drive_http(card, serial_ckpt, sweep_ckpt, tmp, runs_root):
    """Phase 13: ``python -m dib_tpu_torch serve`` over phase 12's serial
    and 8-replica checkpoints as processes of their own (single, sweep with
    quotas, admission and the cache, --workers 2, --prefork 2), started
    together; every answer held to the direct engine; timings; SIGTERM
    ends each with exit 0 and, for the single process, a summary line
    counting every request it served. Each process writes its event stream
    into its ``--outdir`` (the default ``--telemetry-dir``; a fifth process,
    ``--telemetry-dir ''``, writes none and prices the stream); the single
    process and the prefork fleet register their runs under ``runs_root``
    at SIGTERM."""
    phase_t0 = time.perf_counter()
    serial, members, ends, x = serve_direct_engines(serial_ckpt, sweep_ckpt)
    out = os.path.join(tmp, "serve")
    procs = {}
    try:
        t0 = time.perf_counter()
        for label, argv in (
                ("serial", ["--checkpoint_dir", serial_ckpt, "--runs-root", runs_root]),
                ("sweep", ["--checkpoint_dir", sweep_ckpt, *CLI_SWEEP, "--quota_rps", QUOTA[0],
                           "--quota_burst", QUOTA[1], "--admission_limit", ADMISSION_LIMIT,
                           "--response_cache", RESPONSE_CACHE]),
                ("workers", ["--checkpoint_dir", serial_ckpt, "--workers", "2",
                             "--probe_after_s", "0.5", "--probe_timeout_s", "60"]),
                ("prefork", ["--checkpoint_dir", serial_ckpt, "--prefork", "2",
                             "--runs-root", runs_root]),
                ("quiet", ["--checkpoint_dir", serial_ckpt, "--telemetry-dir", ""])):
            procs[label] = ServeProcess(label, [*argv, "--port", "0",
                                                "--outdir", os.path.join(out, label)])
        hellos = {label: proc.wait_hello() for label, proc in procs.items()}
        start_s = time.perf_counter() - t0
        print(f"HTTP: 5 serve processes started together, every hello line after "
              f"{start_s:.1f} s: " + json.dumps(hellos))
        sent, sent_rows, serve_err = check_serial_server(procs["serial"], serial, x)
        sweep_err = check_sweep_server(procs["sweep"], members, ends, x)
        check_pool_server(procs["workers"], serial, x)
        check_prefork_server(procs["prefork"], card)
        figures, timed, timed_rows = time_http(card, procs, serial, x)
        cost, priced = time_stream_cost(card, procs, x)
        sent, sent_rows = sent + timed + priced, sent_rows + timed_rows + priced
        got = served_launches(procs)
        for label, proc in procs.items():
            code, lines = proc.stop()
            if code != 0:
                fail(f"serve {label}: SIGTERM gave exit {code}\n{proc.stderr_tail()}")
            if label == "serial" and (not lines or lines[-1].get("served_requests") != sent):
                fail(f"serve serial: summary {lines[-1:]} after {sent} requests")
        print(f"HTTP: SIGTERM stopped all 5 with exit 0; the single process's summary: "
              f"served_requests {sent}, as sent; phase 13 took "
              f"{time.perf_counter() - phase_t0:.1f} s")
    finally:
        for proc in procs.values():
            proc.kill()
    return dict(serve_err=max(serve_err, sweep_err), figures=figures, launches=got,
                stream_cost=cost, sent=sent, sent_rows=sent_rows,
                dirs={label: os.path.join(out, label) for label in procs}, x=x, serial=serial)


# --------------------------------------------------------------------------
# phase 14: main path 9, training that survives faults and reports them

FAULT_EPOCHS = 4             # the serial rollback: 4 chunks of one epoch of 10 steps
QUARANTINE_EPOCHS = 3        # the sweep's quarantine: 3 chunks of one epoch of 5 steps
POISONED = 5                 # the sweep member poisoned
OVERLAP_EPOCHS = 5           # the overlapped hooks: one call per epoch
WATCHDOG_PLAN = "stall@chunk2:30s,kill@chunk4"
WATCHDOG_FLOOR_S = "5"
# phase 12's cuts with a checkpoint at every epoch: 12 chunks, so the kill
# at the relaunch's 4th boundary comes before the end
WATCHDOG_CUTS = ["--checkpoint_frequency", "1"]
RESULTS = ("beta", "kl_per_feature", "loss", "val_loss", "metric", "val_metric")


def reset_launches():
    from dib_tpu_torch.ops import attention, density

    density.mi_row_stats_launches = 0
    attention.flash_attention_launches = 0
    attention.flash_attention_bf16_launches = 0
    density.log_density_mat_launches = 0


def read_launches() -> dict:
    from dib_tpu_torch.ops import attention, density

    torch.cuda.synchronize()
    return {"mi_row_stats": density.mi_row_stats_launches,
            "flash_attention": attention.flash_attention_launches,
            "flash_attention_bf16": attention.flash_attention_bf16_launches,
            "log_density_mat": density.log_density_mat_launches}


def add_launches(*runs) -> dict:
    return {name: sum(r[name] for r in runs) for name in runs[0]}


def read_stream(label, directory):
    """The run's events.jsonl, every record valid under the port's strict
    schema (a known kind, its envelope and its required fields)."""
    from dib_tpu_torch.telemetry import read_events, validate_event

    events = list(read_events(directory))
    for event in events:
        problems = validate_event(event)
        if problems:
            fail(f"{label}: event {event.get('seq')} of {directory} is not valid: {problems}")
    return events


def same_records(label, got, want, members=None):
    """History records equal bit for bit (a list for a sweep)."""
    pairs = [(got, want)] if members is None else [(got[r], want[r]) for r in members]
    for i, (g, w) in enumerate(pairs):
        for name in RESULTS:
            if not np.array_equal(getattr(g, name), getattr(w, name)):
                fail(f"{label}: {'' if members is None else f'member {members[i]}: '}{name} "
                     f"differs from the uninterrupted run's")


def same_state(label, got, want, members=None):
    """Every weight leaf and Adam moment equal bit for bit (the members'
    slices of a sweep's stacked leaves)."""
    model, want_model = got.params["model"], want.params["model"]
    for (name, param), ref in zip(model.named_parameters(), want_model.parameters()):
        pairs = [(param, ref)] + [(got.optimizer.state[param][slot],
                                   want.optimizer.state[ref][slot])
                                  for slot in ("exp_avg", "exp_avg_sq")]
        for a, b in pairs:
            views = [(a, b)] if members is None else [
                (model.member_values(name, a, r), model.member_values(name, b, r))
                for r in members]
            if not all(torch.equal(x, y) for x, y in views):
                fail(f"{label}: {name} (or its Adam moments) differs from the uninterrupted "
                     f"run's")
    return sum(1 for _ in model.parameters())


def seconds_between(events, first, then):
    """Seconds from the first event matching ``first`` to the next one
    after it matching ``then`` (event predicates)."""
    start = next(i for i, e in enumerate(events) if first(e))
    end = next(e for e in events[start + 1:] if then(e))
    return end["t"] - events[start]["t"]


def drive_rollback(card, flagship, tmp):
    """(a) The serial rollback at full width: the flagship, 4 chunks of one
    epoch with the MI hook and a checkpoint at each, ``nan@chunk2``
    against the same fit without it; then a poison the checkpoint holds."""
    from dib_tpu_torch.faults import FaultPlan, poison_params
    from dib_tpu_torch.telemetry import EventWriter
    from dib_tpu_torch.train import CheckpointHook, DIBCheckpointer, DIBTrainer, InfoPerFeatureHook
    from dib_tpu_torch.workloads import build_model

    config, train_config, bundle = (flagship[k] for k in ("config", "train_config", "bundle"))

    def run(name, plan=None, poison_at=None):
        model = build_model(config, device="cuda", generator=torch.Generator().manual_seed(SEED),
                            use_flash=True)
        trainer = DIBTrainer(model, bundle, train_config)
        hook = InfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches, seed=SEED)
        hooks = [hook, CheckpointHook(DIBCheckpointer(os.path.join(tmp, name, "ckpt")))]
        if poison_at is not None:      # before the checkpoint hook: the step holds the poison
            def poison(tr, st, epoch):
                if epoch == poison_at:
                    poison_params(st.params, float("nan"))

            hooks.insert(1, poison)
        writer = EventWriter(os.path.join(tmp, name))
        reset_launches()
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                state, history = trainer.fit(
                    torch.Generator(device="cuda").manual_seed(SEED), num_epochs=FAULT_EPOCHS,
                    hooks=hooks, hook_every=1, telemetry=writer,
                    fault_plan=FaultPlan.parse(plan) if plan else None)
        finally:
            writer.close()
        wall = time.perf_counter() - t0
        return dict(state=state, history=history, hook=hook, launches=read_launches(),
                    wall_s=wall, events=read_stream(f"rollback {name}", os.path.join(tmp, name)))

    clean = run("clean")
    faulted = run("faulted", plan="nan@chunk2")
    same_records("serial rollback", faulted["history"], clean["history"])
    leaves = same_state("serial rollback", faulted["state"], clean["state"])
    if faulted["hook"].records != clean["hook"].records:
        fail("serial rollback: the MI bounds differ from the uninterrupted run's")
    events = faulted["events"]
    kinds = [e["type"] for e in events]
    (mitigation,) = [e for e in events if e["type"] == "mitigation"]
    faults = [e for e in events if e["type"] == "fault"]
    if (mitigation["mtype"], mitigation["epoch"], mitigation["restored_epoch"]) != \
            ("divergence_rollback", 3, 2) or [(f["kind"], f["chunk"]) for f in faults] != \
            [("nan", 2)] or kinds.count("chunk") != FAULT_EPOCHS + 1 or \
            kinds.count("span") < FAULT_EPOCHS + 1 or not any(
                e["type"] == "heartbeat" and e["phase"] == "boundary" for e in events):
        fail(f"serial rollback: events {kinds}, mitigation {mitigation}")
    blocks = len(faulted["state"].params["model"].aggregator.blocks)
    chunks = FAULT_EPOCHS + 1
    want = {"flash_attention": blocks * chunks * (train_config.steps_per_epoch + 1),
            "mi_row_stats": config.mi_eval_batches * FAULT_EPOCHS}
    if any(faulted["launches"][k] != v for k, v in want.items()):
        fail(f"serial rollback: launches {faulted['launches']}, expected {want}")
    to_restored = seconds_between(events, lambda e: e["type"] == "anomaly",
                                  lambda e: e["type"] == "mitigation")
    to_resumed = seconds_between(events, lambda e: e["type"] == "anomaly",
                                 lambda e: e["type"] == "chunk")
    try:
        run("recurs", poison_at=2)
        fail("serial rollback: a poison the checkpoint holds did not raise")
    except RuntimeError as exc:
        if "diverged again at epoch 3" not in str(exc):
            raise
    recurs = read_stream("rollback recurs", os.path.join(tmp, "recurs"))
    ckpt = DIBCheckpointer(os.path.join(tmp, "clean", "ckpt"))
    trainer = DIBTrainer(build_model(config, device="cuda", use_flash=True,
                                     generator=torch.Generator().manual_seed(SEED)),
                         bundle, train_config)
    restore_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        ckpt.restore(trainer)
        torch.cuda.synchronize()
        restore_ms.append(1e3 * (time.perf_counter() - t0))
    rollbacks = sum(e["type"] == "mitigation" for e in recurs)
    quarantined = sum(e["type"] == "quarantine" for e in recurs)
    print(f"main path launches (serial rollback, {FAULT_EPOCHS} chunks and 1 replayed, "
          f"{FAULT_EPOCHS} MI hook calls): {json.dumps(faulted['launches'])}")
    print(f"serial rollback: nan@chunk2 on the flagship at full width, {FAULT_EPOCHS} chunks "
          f"of {train_config.steps_per_epoch} steps with the MI hook and a checkpoint each: "
          f"rolled back at epoch 3 to epoch 2 and replayed; the history, the MI bounds and "
          f"all {leaves} weight leaves with their Adam moments equal the uninterrupted run's "
          f"bit for bit; {len(events)} events ({', '.join(sorted(set(kinds)))}) valid under "
          f"the strict schema; a poison the checkpoint holds raised after {rollbacks} "
          f"rollbacks and {quarantined} quarantined steps")
    print(f"timing [{card}] serial rollback: detection to restored {to_restored:.4f} s, to "
          f"the replayed chunk's end {to_resumed:.4f} s; fits {clean['wall_s']:.3f} s clean, "
          f"{faulted['wall_s']:.3f} s with the rollback (host clock, one run each); one "
          f"DIBCheckpointer.restore of the flagship's step {statistics.median(restore_ms):.4f} "
          f"ms (median of 3, warm page cache)")
    return dict(launches=add_launches(clean["launches"], faulted["launches"]),
                to_restored=to_restored, to_resumed=to_resumed)


def drive_quarantine(card, sweep_run, tmp):
    """(b) The 8-member sweep at phase 9's widths, 3 chunks of one epoch
    with a checkpoint each: member 5 poisoned once is healed (all eight
    equal the uninterrupted sweep bit for bit); poisoned in every restore
    it is ejected (the other seven equal it bit for bit)."""
    from dib_tpu_torch.faults import FaultPlan, PoisonedReplicaRestore
    from dib_tpu_torch.parallel import BetaSweepTrainer, member_seed
    from dib_tpu_torch.telemetry import EventWriter
    from dib_tpu_torch.train import CheckpointHook, DIBCheckpointer
    from dib_tpu_torch.workloads import build_model

    config, bundle = sweep_run["config"], sweep_run["bundle"]
    ends = np.logspace(-2, 0, 8)
    seeds = [member_seed(SEED, r) for r in range(len(ends))]

    def run(name, plan=None, poison_restores=False):
        model = build_model(config, device="cuda", replicas=len(ends), use_flash=True,
                            generator=[torch.Generator().manual_seed(s) for s in seeds])
        sweep = BetaSweepTrainer(model, bundle, config.train_config(SWEEP_STEPS_PER_EPOCH),
                                 config.beta_start, ends)
        writer = EventWriter(os.path.join(tmp, name))
        ckpt = DIBCheckpointer(os.path.join(tmp, name, "ckpt"))
        if poison_restores:
            ckpt = PoisonedReplicaRestore(ckpt, POISONED, telemetry=writer)
        reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            states, records = sweep.fit(
                [torch.Generator(device="cuda").manual_seed(s) for s in seeds],
                num_epochs=QUARANTINE_EPOCHS, hooks=[CheckpointHook(ckpt)], hook_every=1,
                telemetry=writer, fault_plan=FaultPlan.parse(plan) if plan else None)
        writer.close()
        wall = time.perf_counter() - t0
        return dict(sweep=sweep, states=states, records=records, launches=read_launches(),
                    wall_s=wall, events=read_stream(f"quarantine {name}",
                                                    os.path.join(tmp, name)))

    plan = f"replica_nan@chunk2:{POISONED}"
    clean = run("sweep_clean")
    healed = run("sweep_healed", plan)
    ejected = run("sweep_ejected", plan, poison_restores=True)
    everyone, others = list(range(len(ends))), [r for r in range(len(ends)) if r != POISONED]
    same_records("sweep quarantine (healed)", healed["records"], clean["records"], everyone)
    leaves = same_state("sweep quarantine (healed)", healed["states"], clean["states"], everyone)
    same_records("sweep quarantine (ejected)", ejected["records"], clean["records"], others)
    same_state("sweep quarantine (ejected)", ejected["states"], clean["states"], others)
    incidents = {name: [(e["type"], e.get("mtype") or e.get("kind"), e.get("replica"))
                        for e in r["events"] if e["type"] in ("fault", "mitigation")]
                 for name, r in (("healed", healed), ("ejected", ejected))}
    want = {"healed": [("fault", "replica_nan", POISONED),
                       ("mitigation", "divergence_rollback", POISONED)],
            "ejected": [("fault", "replica_nan", POISONED), ("fault", "replica_nan", POISONED),
                        ("mitigation", "replica_ejected", POISONED)]}
    if incidents != want or healed["sweep"].ejected_replicas or \
            list(ejected["sweep"].ejected_replicas) != [POISONED] or \
            [r.ejected for r in ejected["records"]] != [r == POISONED for r in everyone]:
        fail(f"sweep quarantine: incidents {incidents}, ejected "
             f"{ejected['sweep'].ejected_replicas}")
    blocks = len(clean["states"].params["model"].aggregator.blocks)
    per_epoch = blocks * (SWEEP_STEPS_PER_EPOCH + 1)
    if clean["launches"]["flash_attention"] != per_epoch * QUARANTINE_EPOCHS or any(
            r["launches"]["flash_attention"] != per_epoch * (QUARANTINE_EPOCHS + 1)
            for r in (healed, ejected)):
        fail(f"sweep quarantine: flash launches {[r['launches'] for r in (clean, healed, ejected)]}"
             f", expected {per_epoch} per epoch and one epoch replayed")
    heal_s = seconds_between(healed["events"], lambda e: e["type"] == "chunk" and e["epoch"] == 3,
                             lambda e: e["type"] == "mitigation")
    print(f"main path launches (sweep quarantine, {QUARANTINE_EPOCHS} epochs clean, healed and "
          f"ejected, each replay one epoch at R = 8): "
          f"{json.dumps(add_launches(clean['launches'], healed['launches'], ejected['launches']))}")
    print(f"sweep quarantine: member {POISONED} poisoned at chunk 2 of 8 was healed by one "
          f"restore and a replay at R = 8: all 8 members' records, {leaves} stacked weight "
          f"leaves and Adam moments equal the uninterrupted sweep bit for bit; poisoned in every "
          f"restore it was ejected ({ejected['sweep'].ejected_replicas[POISONED]['reason']}) and "
          f"the other 7 equal it bit for bit; events valid under the strict schema")
    print(f"timing [{card}] sweep quarantine: the poisoned boundary's chunk event to the heal's "
          f"mitigation {heal_s:.4f} s (restore, replay of one epoch at R = 8, splice); sweeps "
          f"{clean['wall_s']:.3f} s clean, {healed['wall_s']:.3f} s healed, "
          f"{ejected['wall_s']:.3f} s ejected (host clock)")
    return dict(launches=add_launches(clean["launches"], healed["launches"],
                                      ejected["launches"]), heal_s=heal_s)


def side_stream_row_stats(trace_path) -> dict:
    """From a chrome trace: the stream of the flash kernels (the training
    stream) and the count of ``mi_row_stats``' kernels on each stream."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    training = {e["args"]["stream"] for e in kernels if "flash_attention" in e["name"]}
    row_stats = [e["args"]["stream"] for e in kernels
                 if any(k in e["name"] for k in ("row_stats_kernel", "stage_kernel",
                                                 "merge_kernel"))]
    side = sum(1 for s in row_stats if s not in training)
    return {"training_streams": sorted(training), "row_stats_kernels": len(row_stats),
            "on_another_stream": side}


def drive_overlap(card, flagship, sweep_run, tmp):
    """(c) ``InfoPerFeatureHook`` and ``SweepInfoPerFeatureHook`` with
    ``overlap=True`` against ``overlap=False``: bounds and training history
    bit for bit; each hook call's exposed host time both ways; the
    profiler's count of ``mi_row_stats`` kernels off the training stream."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from dib_tpu_torch.parallel import BetaSweepTrainer, SweepInfoPerFeatureHook, member_seed
    from dib_tpu_torch.train import DIBTrainer, InfoPerFeatureHook
    from dib_tpu_torch.workloads import build_model

    config, bundle = flagship["config"], flagship["bundle"]
    train_config = dataclasses.replace(config, num_steps=OVERLAP_EPOCHS * STEPS_PER_EPOCH
                                       ).train_config(STEPS_PER_EPOCH)
    sweep_config, sweep_bundle = sweep_run["config"], sweep_run["bundle"]
    sweep_config = dataclasses.replace(sweep_config,
                                       num_steps=OVERLAP_EPOCHS * SWEEP_STEPS_PER_EPOCH)
    ends = np.logspace(-2, 0, 8)
    seeds = [member_seed(SEED, r) for r in range(len(ends))]

    def fit(kind, overlap, profiled=False):
        if kind == "serial":
            model = build_model(config, device="cuda", use_flash=True,
                                generator=torch.Generator().manual_seed(SEED))
            trainer = DIBTrainer(model, bundle, train_config)
            hook = InfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches,
                                      seed=SEED, overlap=overlap)
            draws = torch.Generator(device="cuda").manual_seed(SEED)
        else:
            model = build_model(sweep_config, device="cuda", replicas=len(ends), use_flash=True,
                                generator=[torch.Generator().manual_seed(s) for s in seeds])
            trainer = BetaSweepTrainer(model, sweep_bundle,
                                       sweep_config.train_config(SWEEP_STEPS_PER_EPOCH),
                                       sweep_config.beta_start, ends)
            hook = SweepInfoPerFeatureHook(sweep_config.mi_eval_batch_size,
                                           sweep_config.mi_eval_batches, seed=SEED,
                                           overlap=overlap)
            draws = [torch.Generator(device="cuda").manual_seed(s) for s in seeds]
        exposed = []

        def timed(tr, st, epoch):
            t0 = time.perf_counter()
            hook(tr, st, epoch)
            exposed.append(time.perf_counter() - t0)

        reset_launches()
        context = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                   if profiled else contextlib.nullcontext(None))
        with context as prof:
            _, history = trainer.fit(draws, num_epochs=OVERLAP_EPOCHS, hooks=[timed],
                                     hook_every=1)
            t0 = time.perf_counter()
            records = hook.records            # collects the last overlapped call
            exposed[-1] += time.perf_counter() - t0
            torch.cuda.synchronize()
        launches = read_launches()
        streams = None
        if profiled:
            path = os.path.join(tmp, f"overlap_{kind}.json")
            prof.export_chrome_trace(path)
            streams = side_stream_row_stats(path)
        return dict(history=history, records=records, exposed=exposed, launches=launches,
                    streams=streams)

    results, launches = {}, []
    for kind in ("serial", "sweep"):
        plain, overlapped = fit(kind, False), fit(kind, True)
        profiled = fit(kind, True, profiled=True)
        for label, got in (("overlapped", overlapped), ("profiled", profiled)):
            same_records(f"overlap {kind} ({label})", got["history"], plain["history"],
                         None if kind == "serial" else list(range(len(ends))))
            if len(got["records"]) != OVERLAP_EPOCHS or not all(
                    g["epoch"] == w["epoch"] and np.array_equal(g["bounds"], w["bounds"])
                    for g, w in zip(got["records"], plain["records"])):
                fail(f"overlap {kind} ({label}): the MI bounds differ from overlap=False")
        streams = profiled["streams"]
        if streams["row_stats_kernels"] == 0 or streams["on_another_stream"] == 0 or \
                len(streams["training_streams"]) != 1:
            fail(f"overlap {kind}: no mi_row_stats kernel ran off the training stream: {streams}")
        launches += [plain["launches"], overlapped["launches"], profiled["launches"]]
        # the first overlapped call builds the shadow model and the side
        # stream; the last one also waits for its own measurement
        results[kind] = {"plain_ms": 1e3 * statistics.median(plain["exposed"][1:-1]),
                         "overlapped_ms": 1e3 * statistics.median(overlapped["exposed"][1:-1]),
                         "streams": streams}
        print(f"overlap {kind}: overlap=True equals overlap=False bit for bit (the bounds of "
              f"{OVERLAP_EPOCHS} calls and the training history); profiler: "
              f"{streams['on_another_stream']} of {streams['row_stats_kernels']} mi_row_stats "
              f"kernels ran off the training stream {streams['training_streams']}")
        print(f"timing [{card}] overlap {kind} hook, exposed host time per call (median of "
              f"calls 2-{OVERLAP_EPOCHS - 1}): overlap=False {results[kind]['plain_ms']:.4f} ms, "
              f"overlap=True {results[kind]['overlapped_ms']:.4f} ms; every call (the first "
              f"overlapped one builds the shadow, the last also collects itself) "
              f"{[round(1e3 * s, 4) for s in plain['exposed']]} vs "
              f"{[round(1e3 * s, 4) for s in overlapped['exposed']]} ms")
    total = add_launches(*launches)
    print(f"main path launches (overlapped hooks, {OVERLAP_EPOCHS} epochs each, serial and "
          f"sweep, plain / overlapped / profiled): {json.dumps(total)}")
    return dict(launches=total, results=results)


def drive_watchdog(card, tmp):
    """(d) ``python -m dib_tpu_torch train --watchdog`` at the CLI's
    defaults, cut as in phase 12 with a checkpoint at every epoch, with
    ``DIB_FAULT_PLAN=stall@chunk2:30s,kill@chunk4``, against the same
    command in process without the watchdog and the faults."""
    whole, run = os.path.join(tmp, "wd_whole"), os.path.join(tmp, "wd_run")
    summary, launches, whole_s = cli_in_process(cli_argv(whole, whole + "_ckpt",
                                                         *WATCHDOG_CUTS))
    argv = cli_argv(run, run + "_ckpt", *WATCHDOG_CUTS, "--watchdog", "--watchdog_floor_s",
                    WATCHDOG_FLOOR_S)
    env = dict(os.environ, DIB_FAULT_PLAN=WATCHDOG_PLAN,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([*CLI_COMMAND, *argv], cwd=ROOT, env=env, text=True,
                          capture_output=True, timeout=CLI_TIMEOUT)
    watchdog_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"watchdog: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])["watchdog"]
    kinds = [m["type"] for m in report["mitigations"]]
    if report["returncode"] != 0 or report["launches"] != 3 or \
            kinds != ["stall_kill", "crash_restart"]:
        fail(f"watchdog: report {report}")
    same_files("watchdog", run, whole, ["history.npz"])
    events = read_stream("watchdog", run)
    faults = [e["kind"] for e in events if e["type"] == "fault"]
    mitigations = [(e["mtype"], (e.get("tags") or {}).get("src")) for e in events
                   if e["type"] == "mitigation"]
    starts = [e for e in events if e["type"] == "run_start"]
    if faults != ["stall", "kill"] or mitigations != [("stall_kill", "supervisor"),
                                                      ("crash_restart", "supervisor")] or \
            len(starts) != 3 or events[-1]["type"] != "run_end" or \
            len({e["run"] for e in events}) != 1:
        fail(f"watchdog: faults {faults}, mitigations {mitigations}, {len(starts)} run_start")
    stall = next(e for e in events if e["type"] == "fault" and e["kind"] == "stall")
    kill = next(e for e in events if e["type"] == "mitigation")
    relaunch = starts[1]
    first_chunk = next(e for e in events[events.index(relaunch):] if e["type"] == "chunk")
    stall_to_kill, kill_to_start = kill["t"] - stall["t"], relaunch["t"] - kill["t"]
    stall_to_chunk = first_chunk["t"] - stall["t"]
    print(f"main path launches (watchdog's uninterrupted run in process, {CLI_EPOCHS} "
          f"epochs): {json.dumps(launches)}")
    print(f"watchdog: python -m dib_tpu_torch train --watchdog --watchdog_floor_s "
          f"{WATCHDOG_FLOOR_S}, DIB_FAULT_PLAN={WATCHDOG_PLAN}: exit 0 after "
          f"{report['launches']} launches, mitigations {json.dumps(report['mitigations'])}; "
          f"history.npz equals the uninterrupted run's bit for bit; {len(events)} events of "
          f"one run id valid under the strict schema")
    print(f"timing [{card}] watchdog: stall to kill {stall_to_kill:.3f} s (floor "
          f"{WATCHDOG_FLOOR_S} s), kill to the relaunch's run_start {kill_to_start:.3f} s, "
          f"stall to the relaunch's first chunk {stall_to_chunk:.3f} s; supervised run "
          f"{watchdog_s:.3f} s, in process without faults {whole_s:.3f} s (host clock)")
    return dict(launches=launches, stall_to_kill=stall_to_kill,
                stall_to_chunk=stall_to_chunk)


def drive_durability(card, flagship, sweep_run, tmp):
    """Phase 14, in the directory ``tmp``: (a) the serial rollback, (b) the
    sweep's quarantine, (c) the overlapped hooks, (d) the watchdog (the
    caller writes the event streams in strict mode). Phase 15 reads (a)'s
    stream, ``<tmp>/faulted``."""
    os.makedirs(tmp)
    t0 = time.perf_counter()
    rollback = drive_rollback(card, flagship, tmp)
    quarantine = drive_quarantine(card, sweep_run, tmp)
    overlap = drive_overlap(card, flagship, sweep_run, tmp)
    watchdog = drive_watchdog(card, tmp)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return dict(launches=add_launches(rollback["launches"], quarantine["launches"],
                                      overlap["launches"], watchdog["launches"]),
                rollback=rollback, quarantine=quarantine, overlap=overlap, watchdog=watchdog,
                rollback_dir=os.path.join(tmp, "faulted"))


# --------------------------------------------------------------------------
# phase 15: main path 10, the event stream end to end

# predicts of 1 row to each clean in-process server, served in turns at
# concurrency 1; with fewer, a phase's p99 is the host's tail and two clean
# runs differ past the threshold (scripts/compare_noise.py, PERF.md)
STREAM_REQUESTS = 4000
SLOW_REQUESTS = 500          # the slowed run's predicts: its p99 is the delay's
STREAM_DELAY_S = 0.01        # the slowed run's injected delay per engine dispatch
STREAM_THRESHOLD = "0.5"     # telemetry compare's relative threshold
EJECTED = 2                  # the sweep zoo member failed until ejected (beta_end 0.1)


def telemetry_cli(*argv, expect=0) -> str:
    """``python -m dib_tpu_torch telemetry ...`` in a process of its own;
    fails unless it exits with ``expect``. Returns its stdout."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([*CLI_COMMAND, "telemetry", *argv], cwd=ROOT, env=env, text=True,
                          capture_output=True, timeout=300)
    if proc.returncode != expect:
        fail(f"telemetry {' '.join(argv)}: exit {proc.returncode}, expected {expect}\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


def serve_stream(label, directory, ok=None, rows=None):
    """A serving run's stream: every event valid under the strict schema,
    ``run_start`` with ``mode: "serve"`` first, ``metrics`` then ``run_end``
    last; with ``ok``/``rows``, that many ``status="ok"`` request spans and
    that many rows over the batch spans. Returns the events."""
    events = read_stream(label, directory)
    kinds = [e["type"] for e in events]
    if not events or kinds[0] != "run_start" or kinds[-2:] != ["metrics", "run_end"] or \
            events[0]["manifest"].get("mode") != "serve" or events[-1]["status"] != "ok":
        fail(f"{label}: the stream of {directory} reads {kinds[:3]} ... {kinds[-3:]}; expected "
             f"run_start (mode serve) ... metrics, run_end ok")
    spans = [e for e in events if e["type"] == "span"]
    n_ok = sum(e["name"] == "request" and e["status"] == "ok" for e in spans)
    n_rows = sum(e["rows"] for e in spans if e["name"] == "batch")
    if (ok is not None and n_ok != ok) or (rows is not None and n_rows != rows):
        fail(f"{label}: {n_ok} ok request spans and {n_rows} batch rows; the client got "
             f"{ok} ok answers and sent {rows} rows")
    return events


# one client process at concurrency 1 over several servers in turns (argv:
# pairs of url and request count): each round sends one request to every
# server with requests left, so drift of the host over the run reaches each
# server alike; prints each server's (latency s, status) list as JSON
TURNS_CLIENT = r"""
import http.client, json, sys, time
from urllib.parse import urlparse
urls, counts = [urlparse(u) for u in sys.argv[1::2]], [int(n) for n in sys.argv[2::2]]
body = sys.stdin.readline().encode()
conns = [http.client.HTTPConnection(u.hostname, u.port, timeout=120) for u in urls]
out = [[] for _ in urls]
order = [k for r in range(max(counts)) for k in range(len(urls)) if r < counts[k]]
for k in order:
    t0 = time.perf_counter()
    conns[k].request("POST", "/v1/predict", body, {"Content-Type": "application/json"})
    resp = conns[k].getresponse()
    resp.read()
    out[k].append((time.perf_counter() - t0, resp.status))
print(json.dumps(out), flush=True)
"""


def turns(targets: dict, x) -> dict:
    """TURNS_CLIENT over ``targets`` (url -> requests), predicts of 1 row;
    fails on any status but 200. Returns each url's latencies (s)."""
    client = subprocess.run(
        [sys.executable, "-c", TURNS_CLIENT, *[str(a) for item in targets.items() for a in item]],
        input=json.dumps({"x": x[:1].tolist()}) + "\n", capture_output=True, text=True,
        timeout=900)
    if client.returncode != 0:
        fail(f"the turns client exited {client.returncode}\n{client.stderr}")
    latencies = {}
    for (url, n), answered in zip(targets.items(), json.loads(client.stdout)):
        if {status for _, status in answered} != {200} or len(answered) != n:
            fail(f"turns on {url}: statuses {sorted({status for _, status in answered})}, "
                 f"{len(answered)} answers of {n}")
        latencies[url] = [seconds for seconds, _ in answered]
    return latencies


def in_process_serve(runs: dict, engine, x) -> dict:
    """One ``DIBServer`` in this process per entry of ``runs`` (directory ->
    (injected delay s, requests)), each over ``engine`` (behind a
    ``FlakyEngine`` that sleeps that long per dispatch when it is not 0)
    and writing its stream into its directory; one client sends each server
    its requests, predicts of 1 row, in turns. Returns each directory's
    client latencies (s)."""
    from dib_tpu_torch.faults import FlakyEngine
    from dib_tpu_torch.serve import DIBServer, MicroBatcher, ReplicaEntry, ReplicaRouter
    from dib_tpu_torch.telemetry import EventWriter, MetricsRegistry, runtime_manifest
    from dib_tpu_torch.telemetry.trace import Tracer

    servers = {}
    try:
        for directory, (delay_s, _) in runs.items():
            writer = EventWriter(directory)
            writer.run_start(runtime_manifest(extra={"mode": "serve", "delay_s": delay_s}))
            registry, tracer = MetricsRegistry(), Tracer(writer)
            replica = FlakyEngine(engine, delay_s=delay_s) if delay_s else engine
            router = ReplicaRouter([ReplicaEntry(replica, MicroBatcher(replica, tracer=tracer,
                                                                       registry=registry), 0)],
                                   probe_after_s=0.0, telemetry=writer, registry=registry)
            servers[directory] = DIBServer(router, telemetry=writer, registry=registry,
                                           tracer=tracer).start()
        by_url = turns({servers[d].url: n for d, (_, n) in runs.items()}, x)
    finally:
        for server in servers.values():
            server.close()
    for directory, (_, n) in runs.items():
        serve_stream(f"in-process serving {directory}", directory, ok=n, rows=n)
    return {directory: by_url[servers[directory].url] for directory in runs}


def sweep_zoo_drill(directory, sweep_ckpt, x):
    """Phase 12's 8-member sweep checkpoint as a zoo in this process: member
    EJECTED behind a ``FlakyEngine`` fails a request's dispatch and its
    retry, is ejected (the request answered by the other member of its
    endpoint), re-admitted by a probe, and answers again."""
    from dib_tpu_torch import cli
    from dib_tpu_torch.faults import FlakyEngine
    from dib_tpu_torch.parallel import BetaSweepTrainer
    from dib_tpu_torch.serve import DIBServer, ModelZoo
    from dib_tpu_torch.telemetry import EventWriter, MetricsRegistry, runtime_manifest
    from dib_tpu_torch.telemetry.trace import Tracer

    args = cli.serve_parser().parse_args(["--checkpoint_dir", sweep_ckpt, *CLI_SWEEP])
    bundle = cli._bundle_from_args(args)
    ends = np.repeat(np.asarray(args.sweep_beta_ends, np.float64), args.sweep_repeats)
    stacked, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE, replicas=len(ends))
    sweep = BetaSweepTrainer(stacked, bundle, cli._serve_config(args), args.beta_start, ends,
                             device=CLI_DEVICE)
    writer = EventWriter(directory)
    writer.run_start(runtime_manifest(extra={"mode": "serve", "sweep": True}))
    registry, tracer = MetricsRegistry(), Tracer(writer)
    zoo = ModelZoo(telemetry=writer, registry=registry)
    router = zoo.add_sweep_checkpoint("default", sweep_ckpt, sweep, telemetry=writer,
                                      tracer=tracer, registry=registry, eject_after=1,
                                      probe_after_s=0.0)
    entry = router.entries[EJECTED]
    flaky = FlakyEngine(entry.engine, telemetry=writer, replica=EJECTED)
    entry.engine = entry.batcher.engine = flaky
    server = DIBServer(zoo, telemetry=writer, registry=registry, tracer=tracer).start()
    body = {"x": x[:4].tolist(), "beta": float(ends[EJECTED])}
    try:
        answered = [http_json(server.url, "/v1/predict", body)]
        flaky.fail_next = 2          # the batch and its per-request retry
        answered.append(http_json(server.url, "/v1/predict", body))
        ejected = entry.ejected
        readmitted = router.probe_ejected(force=True)
        answered.append(http_json(server.url, "/v1/predict", body))
    finally:
        server.close()
    replicas = [payload.get("replica", {}).get("replica") for _, payload in answered]
    if [status for status, _ in answered] != [200] * 3 or not ejected or readmitted != 1 or \
            replicas[0] != EJECTED or replicas[1] == EJECTED or replicas[2] != EJECTED:
        fail(f"sweep zoo drill: statuses {[a[0] for a in answered]}, replicas {replicas}, "
             f"ejected {ejected}, re-admitted {readmitted}")
    events = serve_stream("sweep zoo drill", directory, ok=3, rows=12)
    mitigations = [(e["mtype"], e.get("replica")) for e in events if e["type"] == "mitigation"]
    faults = [(e["kind"], e.get("replica")) for e in events if e["type"] == "fault"]
    if mitigations != [("replica_ejected", EJECTED), ("replica_readmitted", EJECTED)] or \
            faults != [("replica_error", EJECTED)] * 2:
        fail(f"sweep zoo drill: mitigations {mitigations}, faults {faults}")
    return dict(replicas=replicas, ends=ends, events=len(events))


def drive_events(card, tmp, cli_run, http_run, durability, runs_root):
    """Phase 15: the event streams that phases 12-14 wrote, and three more
    serving runs in this process, read back with ``python -m dib_tpu_torch
    telemetry``; nothing is trained."""
    phase_t0 = time.perf_counter()
    reset_launches()
    dirs = http_run["dirs"]
    # (a) the serving streams of phase 13
    serial = serve_stream("serve serial", dirs["serial"], ok=http_run["sent"],
                          rows=http_run["sent_rows"])
    trace_ids = set()
    for k in range(2):
        worker = serve_stream(f"serve prefork worker{k}", os.path.join(dirs["prefork"],
                                                                       f"worker{k}"))
        trace_ids |= {(e.get("ctx") or {}).get("trace_id") for e in worker}
    if len(trace_ids) != 1 or None in trace_ids:
        fail(f"serve prefork: the workers' streams carry trace ids {trace_ids}, expected one")
    for label in ("sweep", "workers"):
        serve_stream(f"serve {label}", dirs[label])
    if os.path.exists(os.path.join(dirs["quiet"], "events.jsonl")):
        fail("serve --telemetry-dir '': a stream was written")
    print(f"event stream (a): phase 13's serve processes each wrote <outdir>/events.jsonl, "
          f"every event valid under the strict schema, run_start (mode serve) first, metrics "
          f"and run_end last; the single process's {len(serial)} events hold "
          f"{http_run['sent']} ok request spans, as the client got, and batch spans of "
          f"{http_run['sent_rows']} rows, as sent; the prefork workers wrote worker0/ and "
          f"worker1/ under one trace id {trace_ids.pop()}; --telemetry-dir '' wrote none")
    # (b) replica ejection and re-admission in a sweep zoo
    drill = sweep_zoo_drill(os.path.join(tmp, "events", "zoo"), cli_run["sweep_ckpt"],
                            http_run["x"])
    print(f"event stream (b): the 8-member sweep zoo, member {EJECTED} (beta_end "
          f"{drill['ends'][EJECTED]}) failed until ejected and re-admitted by a probe: answers "
          f"from members {drill['replicas']}; its {drill['events']} events read fault "
          f"replica_error x2, mitigation replica_ejected then replica_readmitted for member "
          f"{EJECTED}, then metrics, run_end")
    # (c) three servers in this process, served in turns: two clean, one slowed
    runs = {name: os.path.join(tmp, "events", name) for name in ("clean_a", "clean_b", "slow")}
    latencies = in_process_serve({path: (STREAM_DELAY_S, SLOW_REQUESTS) if name == "slow"
                                  else (0.0, STREAM_REQUESTS) for name, path in runs.items()},
                                 http_run["serial"], http_run["x"])
    client = {name: latencies[path] for name, path in runs.items()}
    # (d) the reader
    read = {"serve serial": dirs["serial"], "CLI serial": cli_run["serial_dir"],
            "CLI sweep": cli_run["sweep_dir"], "rollback": durability["rollback_dir"],
            "clean in-process serve": runs["clean_a"]}
    records = {label: json.loads(telemetry_cli("summarize", path))
               for label, path in read.items()}
    served = records["serve serial"]["serving"]
    if served["requests"] != http_run["sent"] or served["statuses"] != {"ok": http_run["sent"]}:
        fail(f"summarize serve serial: serving {served}, expected {http_run['sent']} ok")
    clean = records["clean in-process serve"]["serving"]
    client_p50 = quantiles_ms(client["clean_a"])["p50"]
    if clean["requests"] != STREAM_REQUESTS or not 0 < clean["request_p50_ms"] <= client_p50:
        fail(f"summarize clean in-process serve: {clean['requests']} requests, p50 "
             f"{clean['request_p50_ms']} ms against the client's {client_p50} ms")
    for label, replicas in (("CLI serial", 1), ("CLI sweep", 8)):
        record = records[label]      # a sweep's chunk events count every member's steps
        if record["status"] != "ok" or record["total_steps"] != CLI_EPOCHS * 8 * replicas or \
                record["num_chunks"] != CLI_EPOCHS // CLI_CADENCE:
            fail(f"summarize {label}: {record}")
    faults = records["rollback"].get("faults") or {}
    if faults.get("by_kind") != {"nan": {"injected": 1, "detected": 1, "recovered": 1}} or \
            records["rollback"]["mitigations"] != {"divergence_rollback": 1}:
        fail(f"summarize rollback: faults {faults}, mitigations "
             f"{records['rollback']['mitigations']}")
    steady = json.loads(telemetry_cli("compare", runs["clean_a"], runs["clean_b"],
                                      "--threshold", STREAM_THRESHOLD, expect=0))
    slowed = json.loads(telemetry_cli("compare", runs["clean_a"], runs["slow"],
                                      "--threshold", STREAM_THRESHOLD, expect=1))
    dispatch = slowed["fields"].get("serving_phase_dispatch_p99_ms") or {}
    if not dispatch.get("regressed") or slowed["fields"]["faults_undetected"]["regressed"]:
        fail(f"compare slowed: {json.dumps(slowed['fields'])}")
    reports = {label: telemetry_cli("report", path).strip()
               for label, path in {**read, **runs}.items()}
    for label, path in reports.items():
        with open(path) as f:
            if not f.read().startswith("<!DOCTYPE html>"):
                fail(f"telemetry report {label}: {path} is not the HTML report")
    index = telemetry_cli("report", "--index", "--runs-root", runs_root).strip()
    listed = telemetry_cli("runs", "list", "--runs-root", runs_root)
    registered = {"CLI serial": cli_run["serial_dir"], "CLI sweep": cli_run["sweep_dir"],
                  "serve serial": dirs["serial"],
                  **{f"serve prefork worker{k}": os.path.join(dirs["prefork"], f"worker{k}")
                     for k in range(2)}}
    for label, path in registered.items():
        run_id = read_stream(label, path)[0]["run"]
        if run_id not in listed:
            fail(f"telemetry runs list: {label} ({run_id}) is not registered:\n{listed}")
    launches = read_launches()
    print(f"main path launches (event stream: phase 15's serving runs and readers; serving "
          f"runs cuBLAS matmuls and the readers only the host): {json.dumps(launches)}")
    print(f"event stream (c, d): python -m dib_tpu_torch telemetry summarize exit 0 on "
          f"{', '.join(read)}; the serve record counts {served['requests']} requests as sent "
          f"(p50 {served['request_p50_ms']} ms, p99 {served['request_p99_ms']} ms); clean_a "
          f"{clean['requests']} requests, server p50 {clean['request_p50_ms']} ms <= the "
          f"client's {client_p50} ms; the rollback's faults block nan injected 1, detected 1, "
          f"recovered 1; compare --threshold {STREAM_THRESHOLD} of two clean runs exit 0, "
          f"against a run slowed by FlakyEngine(delay_s={STREAM_DELAY_S}) exit 1 (dispatch "
          f"p99 {dispatch.get('a')} -> {dispatch.get('b')} ms); report wrote "
          f"{len(reports)} HTML files and the index {index}; runs list holds "
          f"{', '.join(registered)} (DIB_RUNS_ROOT for train, --runs-root for serve)")
    print(f"timing [{card}] in-process serving, predicts of 1 row at concurrency 1 "
          f"({STREAM_REQUESTS} to each clean server, {SLOW_REQUESTS} to the slowed one), the "
          f"three servers in turns, client latency ms (host clock): " + json.dumps(
              {name: quantiles_ms(v) for name, v in client.items()})
          + f"; server request p50/p99 ms of clean_a {clean['request_p50_ms']}/"
          f"{clean['request_p99_ms']}; phase 15 took {time.perf_counter() - phase_t0:.1f} s")
    return dict(launches=launches)


# --------------------------------------------------------------------------
# phase 16: main path 11, every dataset and three more workloads

# the CLI's cuts of phase 12 (4 + 8 epochs, MI bounds and checkpoints every
# 4); the pendulum's 16,875 steps per epoch at batch 128 are cut to 8
PENDULUM_STEPS = ["--steps_per_epoch", "8"]
PENDULUM_DRIFT_TOL = 1e-3     # fractional energy drift of a kept trajectory
PENDULUM_ENERGY = 9.81        # the energy every initial condition is drawn at (E/g = 4)
# a kept trajectory drifts under the tolerance from its initial condition's
# energy, which float32 rounding sets within ~1e-6 of PENDULUM_ENERGY
PENDULUM_IC_SLACK = 1e-5
# the boolean workload at its defaults, 50,000 steps cut to 2,000 with the
# defaults' cadence of 250 kept: 8 MI checks
BOOLEAN_STEPS, BOOLEAN_MI_EVERY = 2000, 250
# the radial shells at their defaults, 200 + 2000 epochs cut to 20 + 40,
# the MI hook's cadence cut with them (every 200 of 2200 epochs, 11
# checks; every 5 of 60, 12), so the checks span the anneal
RADIAL_EPOCHS, RADIAL_EVAL_EVERY = (20, 40), 5
# bits: the peak shell profile's largest entry must reach this (an MI hook
# that reads ~0 everywhere shows no profile) ...
RADIAL_PEAK_MIN_BITS = 0.05
# ... and nats: the kernel-vs-plain call's largest lower bound, so that
# BOUNDS_TOL is small beside what it compares
RADIAL_CHECKED_MIN_NATS = 100 * BOUNDS_TOL
CHARACTERIZATION_SLACK = 0.02  # bits: lower <= upper + slack in each cell


def mi_kernel_vs_plain(label, mus, logvars, gen, min_lower_nats=None):
    """One MI call through the kernel and through the plain version on the
    same draw: each channel's sandwich bounds within BOUNDS_TOL nats, and,
    given ``min_lower_nats``, the plain lower bounds reaching it somewhere.
    Its launches are made after the run's counts were read."""
    from dib_tpu_torch.ops import density
    from dib_tpu_torch.ops.gaussian import reparameterize
    from dib_tpu_torch.ops.info_bounds import sandwich_from_row_stats

    mus, logvars = mus.contiguous(), logvars.contiguous()
    u = reparameterize(mus, logvars, gen).contiguous()
    got = sandwich_from_row_stats(*density.mi_row_stats(u, mus, logvars))
    want = sandwich_from_row_stats(*row_stats_plain(u, mus, logvars))
    g, n, d = mus.shape
    if min_lower_nats is not None and want[0].max().item() < min_lower_nats:
        fail(f"{label}: the checked MI call's lower bounds reach {want[0].max().item():.3e} "
             f"nats, under {min_lower_nats}")
    return compare(f"{label}: MI call G={g} N={n} d={d}, kernel vs plain (nats)",
                   got, want, BOUNDS_TOL)


def trained_cli_model(argv, ckpt, epoch):
    """The model a CLI run trained, its weights read from the final step's
    leaves; with the run's bundle."""
    from dib_tpu_torch import cli

    args = cli.build_parser().parse_args(argv)
    bundle = cli._bundle_from_args(args, CLI_DEVICE)
    model, _ = cli._model_from_args(args, bundle, device=CLI_DEVICE)
    model.load_state_dict({name[len("params/model."):]: torch.from_numpy(value)
                           for name, value in checkpoint_leaves(ckpt, epoch).items()
                           if name.startswith("params/model.")})
    return model, bundle


def cli_dataset_run(label, tmp, dataset, *extra, source=None):
    """``train --dataset <dataset>`` in this process at the CLI's defaults and
    phase 12's cuts, then one MI call of the trained model through the
    kernel and the plain version."""
    out, ckpt = os.path.join(tmp, f"{label}_run"), os.path.join(tmp, f"{label}_ckpt")
    argv = ["train", "--dataset", dataset, "--artifact_outdir", out, "--checkpoint_dir", ckpt,
            *CLI_CUTS, *extra]
    summary, launches, wall = cli_in_process(argv)
    if source is not None and summary.get("data_source") != source:
        fail(f"train --dataset {dataset}: run_summary data_source "
             f"{summary.get('data_source')!r}, expected {source!r}")
    with np.load(os.path.join(out, "info_bounds.npz")) as bounds:
        if bounds["epochs"].tolist() != [4, 8, 12] or not np.isfinite(bounds["bounds_bits"]).all():
            fail(f"train --dataset {dataset}: info_bounds epochs {bounds['epochs'].tolist()}")
    if not math.isfinite(summary["final_loss"]):
        fail(f"train --dataset {dataset}: final loss {summary['final_loss']}")
    model, bundle = trained_cli_model(argv, ckpt, CLI_EPOCHS)
    gen = torch.Generator(device=CLI_DEVICE).manual_seed(SEED + 16)
    rows = torch.as_tensor(bundle.x_valid, device=CLI_DEVICE)
    rows = rows[torch.randint(0, len(rows), (EVAL_BATCH,), generator=gen, device=CLI_DEVICE)]
    with torch.inference_mode():
        mus, logvars = model.encode(rows)
    err = mi_kernel_vs_plain(f"train --dataset {dataset}", mus, logvars, gen)
    print(f"train --dataset {dataset}: {bundle.number_features} channels of "
          f"{model.noise_shape(1)[-1]}, {len(bundle.x_train)} training rows, data_source "
          f"{summary.get('data_source')}, final loss {summary['final_loss']:.6f}, "
          f"mi_row_stats launches {launches['mi_row_stats']}, {wall:.3f} s in process")
    return dict(launches=launches, wall_s=wall, err=err, summary=summary)


def drive_pendulum(card, tmp):
    """The double pendulum: ``fetch_double_pendulum`` at its defaults
    simulated on the card (wall time, every kept trajectory's energy within
    the drift tolerance of the energy its initial conditions were drawn at),
    then ``train --dataset double_pendulum --infonce_loss`` on its cache."""
    from dib_tpu_torch.data import pendulum

    data_path = os.path.join(tmp, "pendulum")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = pendulum.fetch_double_pendulum(data_path=data_path, device=CLI_DEVICE)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    trajs = np.load(bundle.extras["cache"])
    energy = pendulum.total_energy(torch.as_tensor(trajs, device=CLI_DEVICE))
    drift = float((energy - PENDULUM_ENERGY).abs().max() / PENDULUM_ENERGY)
    if trajs.shape != (1000, 2500, 4) or not np.isfinite(trajs).all() or \
            drift >= PENDULUM_DRIFT_TOL + PENDULUM_IC_SLACK:
        fail(f"double pendulum: trajectories {trajs.shape}, worst energy drift {drift:.3e}")
    print(f"timing [{card}] double pendulum: fetch_double_pendulum at its defaults, 1000 "
          f"trajectories x 10,000 RK4 steps (dt 1e-2, float32) simulated on the card "
          f"(candidates drawn 1.5x), cached as {os.path.basename(bundle.extras['cache'])}: "
          f"{sim_s:.3f} s (host clock, one run); worst energy drift of a kept state from "
          f"{PENDULUM_ENERGY} {drift:.6e} (< {PENDULUM_DRIFT_TOL} + {PENDULUM_IC_SLACK})")
    run = cli_dataset_run("pendulum", tmp, "double_pendulum", "--infonce_loss",
                          "--data_path", data_path, *PENDULUM_STEPS)
    run["sim_s"] = sim_s
    return run


def drive_boolean(card):
    """The boolean workload at its defaults but the steps: the overlapped
    checks against a direct ``channel_mi_bounds`` on the same weights and
    noise (bit for bit), the step time, and one check through the kernel
    and the plain version."""
    from dib_tpu_torch.ops.entropy import LN2
    from dib_tpu_torch.workloads import (BooleanTrainer, BooleanWorkloadConfig,
                                         run_boolean_workload)
    from dib_tpu_torch.workloads.boolean import BooleanDraws

    config = BooleanWorkloadConfig(num_steps=BOOLEAN_STEPS, mi_every=BOOLEAN_MI_EVERY)
    reset_launches()
    t0 = time.perf_counter()
    result = run_boolean_workload(SEED, config, device=CLI_DEVICE)
    wall = time.perf_counter() - t0
    launches = read_launches()
    history, state = result["history"], result["state"]
    checks = BOOLEAN_STEPS // BOOLEAN_MI_EVERY
    if history["mi_steps"].tolist() != list(range(BOOLEAN_MI_EVERY, BOOLEAN_STEPS + 1,
                                                  BOOLEAN_MI_EVERY)) or \
            launches["mi_row_stats"] != checks or \
            not all(np.isfinite(history[k]).all() for k in history):
        fail(f"boolean: checks at {history['mi_steps'].tolist()}, launches {launches}")
    # the checks' generator (seeded SEED + 1) as it stood before the last
    # check: each check draws one [F, N, d] normal
    trainer = BooleanTrainer(result["bundle"], config, device=CLI_DEVICE)
    shape = state.model.noise_shape(len(trainer._x))
    gen = torch.Generator(device=CLI_DEVICE).manual_seed(SEED + 1)
    for _ in range(checks - 1):
        torch.randn(shape, generator=gen, device=CLI_DEVICE)
    lower, upper = trainer.channel_mi_bounds(state, gen)
    if not (np.array_equal(lower.cpu().numpy() / LN2, history["mi_lower_bits"][-1]) and
            np.array_equal(upper.cpu().numpy() / LN2, history["mi_upper_bits"][-1])):
        fail("boolean: the overlapped check differs from a direct channel_mi_bounds on the "
             "same weights and noise")
    with torch.inference_mode():
        mus, logvars = state.model.encoders(trainer._x)
    err = mi_kernel_vs_plain("boolean", mus, logvars, gen)
    draws = BooleanDraws(torch.Generator(device=CLI_DEVICE).manual_seed(SEED + 17))
    idx, eps = draws.step(len(trainer._x), config.batch_size,
                          state.model.noise_shape(config.batch_size))
    step_ms = host_ms({"step": lambda: trainer.train_step(state, idx, eps, 1.0)})["step"]
    print(f"boolean workload: {config.num_steps} steps (cut from 50,000) of batch "
          f"{config.batch_size}, {checks} overlapped MI checks of G={mus.shape[0]}, "
          f"N={mus.shape[1]}, d={mus.shape[2]} (one launch each), the last equal bit for bit "
          f"to a direct channel_mi_bounds; final accuracy {result['final_accuracy']:.4f}, "
          f"rank agreement with Shapley {result['rank_agreement_shapley']:.4f}")
    print(f"timing [{card}] boolean workload: run_boolean_workload {wall:.3f} s (host clock, "
          f"one run, oracles included); training step {step_ms:.4f} ms (host clock, median "
          f"of 10)")
    return dict(launches=launches, wall_s=wall, step_ms=step_ms, err=err)


def drive_radial_shells(card):
    """The radial shells at their defaults but the epochs and the MI hook's
    cadence. The workload's hook also keeps the encoder's (mu, logvar) on
    one batch of validation rows at every check; the kernel-vs-plain call
    is made after the run on those of the check whose bounds were largest."""
    from dib_tpu_torch.workloads import RadialShellsConfig, radial_shells

    config = RadialShellsConfig(num_pretraining_epochs=RADIAL_EPOCHS[0],
                                num_annealing_epochs=RADIAL_EPOCHS[1],
                                eval_every=RADIAL_EVAL_EVERY)
    gen = torch.Generator(device=CLI_DEVICE).manual_seed(SEED + 18)
    encoded = []

    class KeepingHook(radial_shells.InfoPerFeatureHook):
        def __call__(self, trainer, state, epoch):
            super().__call__(trainer, state, epoch)
            if not encoded:
                self.kept_idx = torch.randint(0, len(self._rows), (config.mi_eval_batch_size,),
                                              generator=gen, device=CLI_DEVICE)
            with torch.inference_mode():
                encoded.append(trainer.model.encode(self._rows[self.kept_idx]))

    reset_launches()
    saved_hook = radial_shells.InfoPerFeatureHook
    radial_shells.InfoPerFeatureHook = KeepingHook
    try:
        t0 = time.perf_counter()
        result = radial_shells.run_radial_shells_workload(SEED, config, device=CLI_DEVICE,
                                                          render=False)
        wall = time.perf_counter() - t0
    finally:
        radial_shells.InfoPerFeatureHook = saved_hook
    launches = read_launches()
    bounds = result["mi_bounds_bits"]
    calls = len(result["mi_epochs"])
    checks = sum(RADIAL_EPOCHS) // RADIAL_EVAL_EVERY
    peak = result["peak_shell_profile_bits"]
    if bounds.shape != (checks, 2 * config.num_shells, 2) or len(encoded) != calls or \
            not np.isfinite(bounds).all() or \
            launches["mi_row_stats"] != calls * config.mi_eval_batches:
        fail(f"radial shells: bounds {bounds.shape}, {len(encoded)} encodings, "
             f"launches {launches}")
    if peak.max() < RADIAL_PEAK_MIN_BITS:
        fail(f"radial shells: peak shell profile {peak.tolist()} bits, none reaches "
             f"{RADIAL_PEAK_MIN_BITS}")
    largest = int(np.argmax(bounds[:, :, 0].sum(-1)))
    mus, logvars = encoded[largest]
    err = mi_kernel_vs_plain(f"radial shells (epoch {result['mi_epochs'][largest]})",
                             mus, logvars, gen, min_lower_nats=RADIAL_CHECKED_MIN_NATS)
    print(f"timing [{card}] radial shells: run_radial_shells_workload at its defaults, "
          f"{sum(RADIAL_EPOCHS)} epochs (cut from 2200) of {len(result['bundle'].x_train)} "
          f"rows, {calls} MI hook calls (every {RADIAL_EVAL_EVERY} epochs, cut from 200) of "
          f"G={mus.shape[0]}, d={mus.shape[2]}: {wall:.3f} s (host clock, one run); peak "
          f"shell profile (bits) {np.round(peak, 4).tolist()}; largest lower bound per check "
          f"(bits) {np.round(bounds[:, :, 0].max(-1), 4).tolist()}")
    return dict(launches=launches, wall_s=wall, err=err)


def drive_characterization(card):
    """The characterization sweep at its defaults: lower <= upper + slack in
    every cell."""
    from dib_tpu_torch.workloads import run_characterization

    reset_launches()
    t0 = time.perf_counter()
    results = run_characterization(device=CLI_DEVICE)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if len(results) != 5 * 7 * 3 or launches["mi_row_stats"] != len(results) * 8:
        fail(f"characterization: {len(results)} cells, launches {launches}")
    for r in results:
        values = (r.mc_truth, r.lower_mean, r.upper_mean, r.lower_std, r.upper_std)
        if not all(math.isfinite(v) for v in values) or \
                r.lower_mean > r.upper_mean + CHARACTERIZATION_SLACK:
            fail(f"characterization: {r}")
    worst = max(results, key=lambda r: abs(r.lower_residual))
    channel = results[0].channel
    gen = torch.Generator(device=CLI_DEVICE).manual_seed(SEED + 19)
    x = channel.sample_x(np.random.default_rng(SEED), 64)
    mus = torch.as_tensor(channel.mus(x), dtype=torch.float32, device=CLI_DEVICE)[None]
    err = mi_kernel_vs_plain("characterization", mus, torch.full_like(mus, channel.logvar), gen)
    print(f"timing [{card}] characterization: run_characterization at its defaults, "
          f"{len(results)} cells (5 channel types x 7 scales x 3 batch sizes, 8 repeats, Monte "
          f"Carlo truth of 20,000 samples on the host): {wall:.3f} s (host clock, one run); "
          f"lower <= upper + {CHARACTERIZATION_SLACK} bits in every cell; the largest lower "
          f"residual {worst.lower_residual:+.4f} bits ({worst.channel.input_bits}-bit X, scale "
          f"{worst.channel.scale:.3f}, B={worst.batch_size})")
    return dict(launches=launches, wall_s=wall, err=err)


def drive_datasets(card):
    """Phase 16: the tabular CLI (diabetes from its committed CSV, mice_protein
    synthetic at 77 channels), the double pendulum, and the boolean, radial
    shells and characterization workloads."""
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_datasets_") as tmp:
        diabetes = cli_dataset_run("diabetes", tmp, "diabetes", "--data_path",
                                   os.path.join(ROOT, "data"), source="real")
        mice = cli_dataset_run("mice", tmp, "mice_protein", "--data_path",
                               os.path.join(tmp, "absent"), source="synthetic")
        pendulum_run = drive_pendulum(card, tmp)
    print(f"timing [{card}] tabular CLI in process (host clock, s): diabetes "
          f"{diabetes['wall_s']:.3f}, mice_protein {mice['wall_s']:.3f}, double_pendulum "
          f"{pendulum_run['wall_s']:.3f}")
    boolean = drive_boolean(card)
    radial = drive_radial_shells(card)
    characterization = drive_characterization(card)
    runs = (diabetes, mice, pendulum_run, boolean, radial, characterization)
    launches = add_launches(*(r["launches"] for r in runs))
    print(f"main path launches (datasets and workloads: diabetes, mice_protein, "
          f"double_pendulum, boolean, radial shells, characterization): "
          f"{json.dumps(launches)}; phase 16 took {time.perf_counter() - phase_t0:.1f} s")
    return dict(launches=launches)


# --------------------------------------------------------------------------
# phase 10: main path 4, the kernel microbench

def run_microbench():
    from dib_tpu_torch.ops import attention, density
    from dib_tpu_torch.scripts import bench_kernels

    density.mi_row_stats_launches = 0
    attention.flash_attention_launches = 0
    density.log_density_mat_launches = 0
    record = bench_kernels.run(reps=3)
    torch.cuda.synchronize()
    launches = {"mi_row_stats": density.mi_row_stats_launches,
                "flash_attention": attention.flash_attention_launches,
                "log_density_mat": density.log_density_mat_launches}
    print(json.dumps(record))
    print(f"main path launches (microbench, {len(record['rows'])} shapes): "
          f"{json.dumps(launches)}")
    if not record["all_parity_ok"]:
        bad = [(r["kind"], r["rows"], r["cols"], r["d"]) for r in record["rows"]
               if not r["parity"]["ok"]]
        fail(f"microbench: parity failed at {bad}")
    if launches["log_density_mat"] == 0 or launches["mi_row_stats"] == 0:
        fail(f"microbench: kernel launches {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 11: timings

def time_flash(card):
    """The flash kernel at the main paths' shapes: event time, the wrapper's
    host time per call, the plain version, SDPA and the bound; then one call
    by kernel. It uses only ``flash_self_attention`` and its plain version,
    so it times the ``dib_tpu_torch`` that is first on the path, of this
    commit or another."""
    import torch.nn.functional as F

    from dib_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {}
    for label, (b, s, h, d, dtype) in {
        "S=50": (32, 50, 12, 128, torch.float32),
        "S=50 B=307": (307, 50, 12, 128, torch.float32),
        "S=1024": (4, 1024, 12, 128, torch.float32),
        "S=50 bf16": (32, 50, 12, 128, torch.bfloat16),
        "S=50 B=256 bf16": (8 * 32, 50, 12, 128, torch.bfloat16),
        "S=1024 bf16": (4, 1024, 12, 128, torch.bfloat16),
    }.items():
        q, k, v = attention_inputs(gen, b, s, h, d, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))   # [B, H, S, D]
        def call():
            return attention.flash_self_attention(q, k, v)

        kernel_ms = time_ms(call, inner=10)
        host_us = host_us_per_call(call)
        plain_ms = time_ms(lambda: attention.flash_self_attention_reference(q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), inner=10)
        bound_ms, bound_by = flash_bound_ms(b, s, h, d, dtype)
        rows[label] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing [{card}] flash_attention B={b} S={s} H={h} D={d} "
              f"{str(dtype).replace('torch.', '')}: kernel {kernel_ms:.4f} ms, host "
              f"{host_us:.1f} us per call, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), roofline share {bound_ms / kernel_ms:.1%}")
        print(f"profile [{card}] flash_attention {label}: {profile_breakdown(call, top=1)}")
    return rows


def time_log_density_mat(card):
    """The density kernel at each microbench shape: event time, the
    wrapper's host time per call, the plain version, the bound and the FP32
    issue floor; then one call by kernel (the staging pass and the main
    kernel apart). It uses only ``log_density_matrix``, its plain version
    and ``GPU_SHAPES``, so it times the ``dib_tpu_torch`` that is first on
    the path, of this commit or another."""
    from dib_tpu_torch.ops import density
    from dib_tpu_torch.scripts.bench_kernels import GPU_SHAPES

    rng = np.random.default_rng(SEED + 9)
    rows = {}
    for _, n, m, d in GPU_SHAPES:
        u, mus, lv = density_inputs(rng, n, m, d)
        def call():
            return density.log_density_matrix(u, mus, lv)

        kernel_ms = time_ms(call, inner=10)
        host_us = host_us_per_call(call)
        plain_ms = time_ms(lambda: density.gaussian_log_density_mat(u, mus, lv), runs=5)
        bound_ms, bound_by = log_density_mat_bound_ms(n, m, d)
        floor_ms = log_density_mat_issue_floor_ms(n, m, d)
        rows[(n, m, d)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, host_us=host_us)
        print(f"timing [{card}] log_density_mat N={n} M={m} d={d} f32: kernel "
              f"{kernel_ms:.4f} ms, host {host_us:.1f} us per call, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), roofline share "
              f"{bound_ms / kernel_ms:.1%}, FP32 issue floor {floor_ms:.4f} ms")
        print(f"profile [{card}] log_density_mat N={n} M={m} d={d}: "
              f"{profile_breakdown(call, top=2)}")
    return rows


# (label, G, rows, columns, d, square mode): the MI query (G = 10 features),
# the MI hook (50 particles), the beta sweep (8 betas x 50), the flagship's
# probe grid against its bank, and a few rows against many columns. Probe
# labels name M probes (the rows) against N data (the columns), as
# ``ops/info_bounds.py::mi_sandwich_probe`` does.
ROW_STATS_SHAPES = [
    ("square G=10 N=1024 d=32", 10, 1024, 1024, 32, True),
    ("square G=50 N=1024 d=32", 50, 1024, 1024, 32, True),
    ("square G=400 N=1024 d=32", 400, 1024, 1024, 32, True),
    ("probe M=10000 N=512 d=32", 1, 10_000, 512, 32, False),
    ("probe M=1000 N=4096 d=32", 1, 1000, 4096, 32, False),
]


def host_us_per_call(fn, calls: int = 20, runs: int = 5) -> float:
    """Median host-clock microseconds for one call of ``fn`` to return:
    ``calls`` calls back to back, the card left to finish after the clock
    stops (the calls only enqueue work)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


def time_row_stats(card):
    """The row statistics kernel at ``ROW_STATS_SHAPES``: event time, the
    wrapper's host time per call, the plain version and the bound; then one
    call by kernel (the staging pass, the main kernel, the merge). It uses
    only ``mi_row_stats`` and its plain version, so it times the
    ``dib_tpu_torch`` that is first on the path, of this commit or another."""
    from dib_tpu_torch.ops import density

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for label, g, n, m, d, diagonal in ROW_STATS_SHAPES:
        u, mus, lv = channel_inputs(gen, g, n, d, m=m, probe=not diagonal)
        def call():
            return density.mi_row_stats(u, mus, lv, diagonal=diagonal)

        ms = time_ms(call, inner=10)
        host_us = host_us_per_call(call)
        plain_ms = time_ms(lambda: row_stats_plain(u, mus, lv, diagonal=diagonal),
                           runs=3, warmup=1)
        bound_ms, bound_by = row_stats_bound_ms(g, n, m, d, u.element_size(), diagonal=diagonal)
        print(f"timing [{card}] mi_row_stats {label} f32: kernel {ms:.4f} ms, host "
              f"{host_us:.1f} us per call, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), roofline share {bound_ms / ms:.1%}")
        print(f"profile [{card}] mi_row_stats {label}: {profile_breakdown(call, top=3)}")


def time_probe_hook(card, driver):
    """One ProbeGridHook call on the trained flagship (rendering off)."""
    from dib_tpu_torch.workloads import ProbeGridHook

    result = driver["result"]
    hook = ProbeGridHook("amorphous_out", result["state"].params["model"],
                         result["bundle"].extras["sets_train"], driver["config"], render=False)
    probe_ms = host_ms({"probe": lambda: hook(None, None, 0)}, runs=5)["probe"]
    print(f"profile [{card}] ProbeGridHook: "
          f"{profile_breakdown(lambda: hook(None, None, 0), unprofiled_ms=probe_ms)}")
    return probe_ms


def time_sweep(card, sweep_run, northstar, step, flagship):
    """The stacked sweep step in float32 and in bfloat16 (the north star's)
    beside the serial flash step (x 8 is the serial sweep), in turns, each
    by kernel; one SweepInfoPerFeatureHook call beside one serial
    InfoPerFeatureHook call (x 8); the validation pass's time and peak memory
    in both types; one SweepCompressionHook call."""
    import tempfile

    from dib_tpu_torch.parallel import BetaSweepTrainer, StackedDraws, SweepCompressionHook
    from dib_tpu_torch.train import GeneratorDraws

    config, bundle, result = sweep_run["config"], sweep_run["bundle"], sweep_run["result"]
    train_config = config.train_config(SWEEP_STEPS_PER_EPOCH)
    sweeps = {}
    for name, run in (("f32", result), ("bf16", northstar["result"])):
        sweeps[name] = (BetaSweepTrainer(run["states"].params["model"], bundle, train_config,
                                         config.beta_start, run["beta_ends"]), run["states"])
    sweep, states = sweeps["f32"]
    replicas, batch = sweep.model.replicas, train_config.batch_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = torch.randint(0, bundle.x_train.shape[0], (replicas, batch), generator=gen,
                         device="cuda")
    x = torch.as_tensor(bundle.x_train, device="cuda")[rows]
    y = torch.as_tensor(bundle.y_train, device="cuda")[rows]
    eps = torch.randn(sweep.model.noise_shape(batch), generator=gen, device="cuda")
    beta = sweep.betas([0])[0]
    (serial_trainer, serial_state) = step["flash"]
    fns = {f"sweep {name}": (lambda sw=sw, st=st: sw.train_step(st, x, y, beta, eps))
           for name, (sw, st) in sweeps.items()}
    fns["serial"] = lambda: serial_trainer.train_step(serial_state, step["x"], step["y"],
                                                      step["beta"], step["eps"])
    step_ms = host_ms(fns)
    for name in sweeps:
        ms = step_ms[f"sweep {name}"]
        print(f"timing [{card}] sweep training step {name}, {replicas} replicas x batch {batch}, "
              f"full width, flash: {ms:.4f} ms; serial f32 flash step {step_ms['serial']:.4f} ms, "
              f"x {replicas} = {replicas * step_ms['serial']:.4f} ms (host clock, median of 10 in "
              f"turns with the other sweep step); speedup {replicas * step_ms['serial'] / ms:.2f}x")
    print(f"timing [{card}] sweep training step bf16 vs f32 (host clock, in turns): "
          f"{step_ms['sweep bf16']:.4f} vs {step_ms['sweep f32']:.4f} ms, "
          f"{step_ms['sweep f32'] / step_ms['sweep bf16']:.2f}x")
    for name in sweeps:
        print(f"profile [{card}] sweep training step {name}: "
              f"{profile_breakdown(fns[f'sweep {name}'], top=8, unprofiled_ms=step_ms[f'sweep {name}'])}")

    hook, trainer, state = flagship["hook"], flagship["trainer"], flagship["state"]
    sweep_hook = sweep_run["hook"]
    hook_ms = host_ms({"sweep": lambda: sweep_hook(sweep, states, 0),
                       "serial": lambda: hook(trainer, state, state.epoch)}, runs=5)
    print(f"timing [{card}] SweepInfoPerFeatureHook G={replicas * config.number_particles} "
          f"batch={sweep_hook.evaluation_batch_size}x{sweep_hook.number_evaluation_batches}: "
          f"{hook_ms['sweep']:.4f} ms; InfoPerFeatureHook G={config.number_particles} "
          f"{hook_ms['serial']:.4f} ms, x {replicas} = {replicas * hook_ms['serial']:.4f} ms "
          f"(host clock, median of 5 in turns)")

    validation = {}
    for name, (sw, st) in sweeps.items():
        generators = [torch.Generator(device="cuda").manual_seed(SEED + 12 + r)
                      for r in range(replicas)]
        draws = StackedDraws([GeneratorDraws(g) for g in generators])

        def validate(sw=sw, draws=draws):
            return sw.validate(beta, draws)

        validate()
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        validate_ms = host_ms({"validate": validate}, runs=3, warmup=0)["validate"]
        peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
        validation[name] = (validate_ms, peak_gb)
        print(f"timing [{card}] sweep validation pass {name}, {replicas} x "
              f"{min(len(bundle.x_valid), train_config.max_val_points)} sets in one forward: "
              f"{validate_ms:.4f} ms (host clock, median of 3); peak device memory above the "
              f"resident {base_bytes / 1e9:.3f} GB: {peak_gb:.3f} GB")
        print(f"profile [{card}] sweep validation pass {name}: "
              f"{profile_breakdown(validate, top=6, unprofiled_ms=validate_ms)}")
    print(f"timing [{card}] whole sweep runs' peak device memory: f32 {sweep_run['peak_gb']:.3f} "
          f"GB, bf16 {northstar['peak_gb']:.3f} GB")

    bf16_sweep, bf16_states = sweeps["bf16"]
    with tempfile.TemporaryDirectory(prefix="northstar_schemes_") as outdir:
        schemes = SweepCompressionHook(outdir, features=(0,))
        schemes_ms = host_ms({"schemes": lambda: schemes(bf16_sweep, bf16_states, 0)},
                             runs=5)["schemes"]
    print(f"timing [{card}] SweepCompressionHook(features=(0,)) call, {replicas} replicas x "
          f"{len(bundle.x_valid)} rows, one stacked encode and one .npz: {schemes_ms:.4f} ms "
          f"(host clock, median of 5)")
    return dict(step_ms=step_ms, hook_ms=hook_ms, validation=validation, schemes_ms=schemes_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from dib_tpu_torch.device import card_line
    from dib_tpu_torch.ops import _build, density

    # ---- 1. card -------------------------------------------------------
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    import scipy

    print(f"scipy {scipy.__version__} (the boolean workload's spearmanr and the tabular "
          f"datasets' norm.ppf)")
    try:
        import tensorstore
    except ImportError as exc:
        print(f"tensorstore: does not import here ({exc}); a reader of JAX/Orbax checkpoints "
              f"cannot use it on this machine")
    else:
        from importlib.metadata import PackageNotFoundError, version

        try:
            release = version("tensorstore")
        except PackageNotFoundError:
            release = "unrecorded"
        print(f"tensorstore: imports here ({tensorstore.__file__}), version {release}")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build(["mi_row_stats", "flash_attention", "log_density_mat"])
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(paths)} kernel sources in parallel")
    usage = {name: print_registers(path) for name, path in paths.items()}
    check_no_spills(usage["log_density_mat"], paths["log_density_mat"],
                    ("log_density_stage_kernel", "log_density_mat_kernel"))
    check_tensor_cores(paths["flash_attention"])

    # ---- 3. kernels vs plain versions on the card ----------------------
    check_row_stats()
    flash_err, flash_bf16_err = check_flash()
    density_errs = check_log_density_mat()

    # ---- 4-10 and 12-15. main paths and their checks -------------------
    serving = serve_and_query()
    flagship = train_flagship()
    paths_step = compare_paths(flagship)
    compare_paths_bf16(flagship, paths_step)
    auto_regime()
    driver = drive_amorphous()
    sweep_run = drive_sweep()
    northstar = drive_northstar()
    card_vs_cpu = hold_bf16_card_vs_cpu(flagship)
    # phases 12-15 write their event streams in strict mode; phase 12's CLI
    # runs register in the run registry through DIB_RUNS_ROOT, phase 13's
    # serve processes through --runs-root
    os.environ["DIB_TELEMETRY_STRICT"] = "1"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
            runs_root = os.path.join(tmp, "runs")
            os.environ["DIB_RUNS_ROOT"] = runs_root
            try:
                cli_run = drive_cli(card, sweep_run, tmp)
            finally:
                os.environ.pop("DIB_RUNS_ROOT", None)
            http_run = drive_http(card, cli_run["serial_ckpt"], cli_run["sweep_ckpt"], tmp,
                                  runs_root)
            durability = drive_durability(card, flagship, sweep_run, os.path.join(tmp, "faults"))
            events_run = drive_events(card, tmp, cli_run, http_run, durability, runs_root)
    finally:
        os.environ.pop("DIB_TELEMETRY_STRICT", None)
    datasets_run = drive_datasets(card)
    bench_launches = run_microbench()

    # ---- 11. timings ---------------------------------------------------
    model, rows, mi_gen = serving["model"], serving["rows"], serving["mi_gen"]
    u, mus, lv = (t.contiguous() for t in serving["stats_in"][-1])
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
    time_row_stats(card)
    flash_rows = time_flash(card)

    from dib_tpu_torch.train.hooks import all_features_bounds

    bounds_ms = time_ms(lambda: all_features_bounds(
        model, rows, EVAL_BATCH, EVAL_BATCHES, generator=mi_gen))
    print(f"timing [{card}] all_features_bounds F={model.num_features} "
          f"batch={EVAL_BATCH}x{EVAL_BATCHES}: {bounds_ms:.4f} ms")
    breakdown = profile_breakdown(lambda: all_features_bounds(
        model, rows, EVAL_BATCH, EVAL_BATCHES, generator=mi_gen), unprofiled_ms=bounds_ms)
    print(f"profile [{card}] all_features_bounds: {breakdown}")
    engine, rows_np = serving["engine"], serving["rows_np"]
    predict_ms = {}
    for bucket in engine.buckets:
        x = rows_np[:bucket]
        predict_ms[bucket] = time_ms(lambda: engine.predict(x))
    print(f"timing [{card}] predict per bucket (ms): {json.dumps(predict_ms)}")
    x_top = rows_np[:engine.max_bucket]
    top_profile = profile_breakdown(lambda: engine.predict(x_top),
                                    unprofiled_ms=predict_ms[engine.max_bucket])
    print(f"profile [{card}] predict bucket {engine.max_bucket}: {top_profile}")

    step = paths_step
    step_fns = {name: (lambda tr=tr, st=st: tr.train_step(st, step["x"], step["y"], step["beta"],
                                                          step["eps"]))
                for name, (tr, st) in (("flash", step["flash"]), ("dense", step["dense"]))}
    step_ms = host_ms(step_fns)
    print(f"timing [{card}] training step, full width, batch "
          f"{flagship['train_config'].batch_size}: flash {step_ms['flash']:.4f} ms, "
          f"dense {step_ms['dense']:.4f} ms (host clock, median of 10 in turns)")
    for name, fn in step_fns.items():
        print(f"profile [{card}] training step ({name}): "
              f"{profile_breakdown(fn, top=8, unprofiled_ms=step_ms[name])}")
    hook, trainer, state = flagship["hook"], flagship["trainer"], flagship["state"]
    hook_ms = host_ms({"hook": lambda: hook(trainer, state, state.epoch)}, runs=5)["hook"]
    print(f"timing [{card}] InfoPerFeatureHook G={trainer.model.num_particles} "
          f"batch={hook.evaluation_batch_size}x{hook.number_evaluation_batches}: "
          f"{hook_ms:.4f} ms (host clock, median of 5)")

    density_rows = time_log_density_mat(card)
    probe_ms = time_probe_hook(card, driver)
    print(f"timing [{card}] run_amorphous_workload, full width, {DRIVER_STEPS} steps with "
          f"{len(driver['result']['mi_epochs'])} MI hook and "
          f"{len(driver['result']['probe_grids'])} probe hook calls: {driver['wall_s']:.3f} s "
          f"(host clock, one run); probe hook {probe_ms:.4f} ms per call")
    time_sweep(card, sweep_run, northstar, paths_step, flagship)

    # ---- 17-18. summary lines ------------------------------------------
    runs = (serving["launches"], flagship["launches"], driver["launches"],
            sweep_run["launches"], northstar["launches"], cli_run["launches"],
            http_run["launches"], durability["launches"], events_run["launches"],
            datasets_run["launches"], bench_launches)
    total = {name: sum(r.get(name, 0) for r in runs)
             for name in ("mi_row_stats", "flash_attention", "flash_attention_bf16",
                          "log_density_mat")}
    print(f"main path launches, all paths: {json.dumps(total)}; mi_row_stats probe mode in the "
          f"driver: {driver['probe_launches']}; bf16 step card vs CPU {card_vs_cpu['step']:.3e} "
          f"of the gradient's norm")
    kernels = [{
        "name": "mi_row_stats",
        "route": "cuda",
        "source": "dib_tpu_torch/csrc/mi_row_stats.cu",
        "replaces": "dib_tpu/ops/pallas_density.py:189",
        "launches": total["mi_row_stats"],
        **k_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "dib_tpu_torch/csrc/flash_attention.cu",
        "replaces": "dib_tpu/ops/pallas_attention.py:87",
        "launches": total["flash_attention"],
        **flash_err,
        **flash_rows["S=50"],
        "bf16": {"shape": "B=8x32 S=50 H=12 D=128", "launches": total["flash_attention_bf16"],
                 **flash_bf16_err, **flash_rows["S=50 B=256 bf16"]},
    }, {
        "name": "log_density_mat",
        "route": "cuda",
        "source": "dib_tpu_torch/csrc/log_density_mat.cu",
        "replaces": "dib_tpu/ops/pallas_density.py:56",
        "launches": total["log_density_mat"],
        **density_errs[(4096, 4096, 32)],
        **density_rows[(4096, 4096, 32)],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
