"""Command-line interface of the port: ``python -m dib_tpu_torch [train] ...``,
``workload``, ``serve`` and ``telemetry`` (counterpart of ``dib_tpu/cli.py``).

``train`` takes the JAX package's flags with the same defaults and trains a
``DistributedIBModel`` on a registered dataset, serially or, with
``--sweep_beta_ends``, as a beta sweep of R replicas in one stacked
program; ``--checkpoint_dir`` saves every ``--checkpoint_frequency`` epochs
and resumes when the directory holds a checkpoint, and SIGTERM/SIGINT
finish the chunk in flight, write a chunk-aligned checkpoint and exit with
75. It writes the run's event stream (``events.jsonl``) into the run
directory unless ``--telemetry-dir ''`` (or another directory) is given,
fires the faults of ``DIB_FAULT_PLAN`` at chunk boundaries (fired-once
marks in the run directory), rolls back a diverged run to its newest
intact checkpoint, and with ``--watchdog`` relaunches itself as a worker
under a supervisor that kills a stalled worker and relaunches a dead one
(``train/watchdog.py``). ``workload amorphous|amorphous_protocols`` runs
the flagship drivers (``--telemetry-dir`` brackets the run with
``run_start`` and ``run_end``), and ``workload
boolean|radial_shells|characterization`` the other paper workloads.
``serve`` serves a checkpoint that ``train`` wrote over the JSON HTTP API of
:mod:`dib_tpu_torch.serve` (serially or a sweep's β-labeled members; in
process, behind ``--workers`` engine subprocesses, or as a ``--prefork``
fleet) and writes the serving run's event stream into ``--outdir`` (each
prefork worker into ``<outdir>/worker<K>``), and ``serve top`` watches a
running fleet. ``telemetry summarize|compare|report|runs`` reads the
streams back (``telemetry/summary.py``). ``--runs-root`` (or
``DIB_RUNS_ROOT``) registers a ``train``, ``workload`` or ``serve`` run in
the run registry at its end.

What the port does not implement is refused before any training, with one
line naming its item in ROADMAP.md, never ignored: meshes (``--mesh_*``,
``--engine shard_map``, item 7), the other subcommands and ``telemetry
tail|check|fleet`` (item 6), the chaos workloads (item 5), contrastive
sweeps (item 8), and serve's ``--exec_cache``. Every dataset of the JAX
package's registry trains; a dataset registered with the InfoNCE loss
(``double_pendulum``) needs ``--infonce_loss`` and is refused at parse
time without it, where the JAX package's trainer refuses it later.

Artifacts (in ``--artifact_outdir``), written in this order:
  - ``history.npz`` (``history_replica{r}.npz`` for a sweep): beta,
    per-feature KL, loss and validation loss series (bits);
  - ``info_bounds.npz`` (``info_bounds_replica{r}.npz``) with
    ``--info_bounds_frequency``, spliced with a pre-crash file on resume;
  - ``run_summary.json``;
  - the distributed info plane(s) as PNG, and compression matrices with
    ``--save_compression_matrices_frequency``. Where matplotlib does not
    import, no PNG is written: one stderr line says so and
    ``run_summary.json`` lists the plots under ``"not_rendered"``
    (compression matrices, drawn during training, are then refused).

The entry points run on the GPU; tests pass ``device="cpu"`` to
:func:`run`, :func:`serve_main` or :func:`main` (under ``--watchdog``
the supervisor hands that device to its workers' command).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
from typing import Sequence

_ITEM = "ROADMAP.md queue 1, item {}"
JAX_CHECKPOINTS = _ITEM.format("1 (reading JAX/Orbax checkpoints)")
WORKLOADS = _ITEM.format("5 (the chaos workloads)")
SUBCOMMANDS = _ITEM.format("6 (the CLI's other subcommands)")
MULTI_GPU = _ITEM.format("7 (multi-GPU replicas)")
CONTRASTIVE_SWEEP = _ITEM.format("8 (contrastive sweeps)")
SERVE_GRAPHS = ("ROADMAP.md, waiting for the port's benchmark: per-bucket CUDA graphs "
                "in the serving engine")

# train flags the port refuses when given a value other than the default
REFUSED_FLAGS = {
    "mesh_beta": MULTI_GPU,
    "mesh_data": MULTI_GPU,
    "engine": MULTI_GPU,
}
# values of those flags that do what the port does: 'vmap' is its stacked program
ACCEPTED_VALUES = {"engine": ("vmap",)}
REFUSED_SUBCOMMANDS = {
    "lint": SUBCOMMANDS,
    "sched": SUBCOMMANDS,
    "stream": SUBCOMMANDS,
    "ckpt": SUBCOMMANDS,
    "study": SUBCOMMANDS,
}
PORTED_WORKLOADS = ("amorphous", "amorphous_protocols", "boolean", "characterization",
                    "radial_shells")


def _add_telemetry_dir_flag(parser: argparse.ArgumentParser, default_desc: str) -> None:
    """``--telemetry-dir`` (its default directory ``default_desc``) and
    ``--runs-root``."""
    parser.add_argument("--telemetry-dir", "--telemetry_dir", dest="telemetry_dir", type=str,
                        default=None,
                        help=f"Directory of the run's event stream, events.jsonl (default: "
                             f"{default_desc}; '' writes none).")
    parser.add_argument("--runs-root", "--runs_root", dest="runs_root", type=str, default="",
                        help="Register the run in this run registry (index.jsonl) at its end "
                             "(default: DIB_RUNS_ROOT, else none).")


def _register_run_dir(args, run_dir: str) -> None:
    """Run-registry registration at the run's end: ``--runs-root``, else
    ``DIB_RUNS_ROOT``, else off. A failed registration warns and never
    fails the run it records (``register_run``)."""
    root = getattr(args, "runs_root", "") or os.environ.get("DIB_RUNS_ROOT")
    if not root:
        return
    from dib_tpu_torch.telemetry.registry import register_run

    register_run(run_dir, root=root)


def _add_model_flags(parser: argparse.ArgumentParser) -> None:
    """Flags that define the model and its dataset (everything needed to
    rebuild the architecture a checkpoint was trained with)."""
    parser.add_argument("--dataset", default="boolean_circuit",
                        help="Registered dataset name (double_pendulum needs "
                             "--infonce_loss).")
    parser.add_argument("--data_path", type=str, default="./data/")
    parser.add_argument("--ib", action=argparse.BooleanOptionalAction, default=False,
                        help="Vanilla IB: all features into a single bottleneck.")
    parser.add_argument("--use_positional_encoding", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--activation_fn", type=str, default="relu")
    parser.add_argument("--feature_embedding_dimension", type=int, default=32,
                        help="Channel width d; with --info_bounds_frequency the GPU's MI "
                             "kernel takes d <= 64.")
    parser.add_argument("--feature_encoder_architecture", type=int, nargs="+",
                        default=[128, 128])
    parser.add_argument("--number_positional_encoding_frequencies", type=int, default=5,
                        help="Reference convention: n yields 2^1..2^(n-1), i.e. n-1 sinusoids.")
    parser.add_argument("--integration_network_architecture", type=int, nargs="+",
                        default=[256, 256])
    parser.add_argument("--infonce_loss", action=argparse.BooleanOptionalAction, default=False)
    parser.add_argument("--infonce_shared_dimensionality", type=int, default=64)
    parser.add_argument("--infonce_y_encoder_architecture", type=int, nargs="+",
                        default=[128, 128])
    parser.add_argument("--boolean_random_circuit", action=argparse.BooleanOptionalAction,
                        default=False)
    parser.add_argument("--boolean_number_input_gates", type=int, default=10)
    parser.add_argument("--pendulum_time_delta", type=float, default=2)
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=[None, "float32", "bfloat16"],
                        help="Matmul compute dtype (parameters stay float32).")
    parser.add_argument("--seed", type=int, default=0)


class _TrainParser(argparse.ArgumentParser):
    """Refuses what the port does not implement as it parses."""

    def parse_args(self, args=None, namespace=None):
        parsed = super().parse_args(args, namespace)
        problem = refusal(parsed, {action.dest: action.default for action in self._actions})
        if problem:
            self.error(problem)
        return parsed


def build_parser() -> argparse.ArgumentParser:
    parser = _TrainParser(
        prog="dib_tpu_torch",
        description="Train a Distributed IB model on the GPU (the PyTorch/CUDA port).",
    )
    parser.add_argument("command", nargs="?", default="train",
                        choices=["train", "workload", "telemetry", "serve", "lint", "sched",
                                 "stream", "ckpt", "study"],
                        help="'train' (flags below), 'workload' (see `dib_tpu_torch "
                             "workload --help`), "
                             "'serve' or 'telemetry'. The others are not ported and are "
                             "refused.")
    _add_model_flags(parser)
    parser.add_argument("--artifact_outdir", type=str, default="./training_artifacts/")
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--beta_start", type=float, default=1e-4)
    parser.add_argument("--beta_end", type=float, default=3e0)
    parser.add_argument("--number_pretraining_epochs", type=int, default=10**3)
    parser.add_argument("--number_annealing_epochs", type=int, default=10**4)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--optimizer", type=str, default="adam", help="'adam' or 'sgd'.")
    parser.add_argument("--save_compression_matrices_frequency", type=int, default=0)
    parser.add_argument("--infonce_similarity", type=str, default="l2",
                        choices=["l2sq", "l2", "l1", "linf", "cosine"])
    parser.add_argument("--infonce_temperature", type=float, default=1.0)
    parser.add_argument("--steps_per_epoch", type=int, default=0,
                        help="0 -> ceil(num_train / batch_size).")
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--max_val_points", type=int, default=4096)
    parser.add_argument("--info_bounds_frequency", type=int, default=0,
                        help="Epoch cadence of per-feature MI sandwich bounds (0 = off).")
    parser.add_argument("--sweep_beta_ends", type=float, nargs="+", default=None,
                        help="Train a replica per end-beta as one stacked program.")
    parser.add_argument("--sweep_repeats", type=int, default=1,
                        help="Independent seeds per sweep endpoint.")
    parser.add_argument("--mesh_beta", type=int, default=None,
                        help=f"Not ported: refused when set; {MULTI_GPU}.")
    parser.add_argument("--mesh_data", type=int, default=None,
                        help=f"Not ported: refused when set; {MULTI_GPU}.")
    parser.add_argument("--engine", choices=("auto", "vmap", "shard_map"), default="auto",
                        help="'auto' and 'vmap' run the stacked program; 'shard_map' is not "
                             f"ported and is refused ({MULTI_GPU}).")
    parser.add_argument("--checkpoint_dir", type=str, default="",
                        help="Save every --checkpoint_frequency epochs (serial and sweep) and "
                             "resume when the directory holds a checkpoint.")
    parser.add_argument("--checkpoint_frequency", type=int, default=500)
    parser.add_argument("--watchdog", action="store_true",
                        help="Supervise the run: relaunch this command as a worker with "
                             "checkpoints and a heartbeat, SIGKILL it when a chunk stalls past 3x "
                             "the trailing-median chunk wall-clock (or --watchdog_floor_s), "
                             "relaunch it when it dies, and let it resume from its checkpoint.")
    parser.add_argument("--heartbeat", type=str, default="",
                        help="Write a chunk-boundary heartbeat JSON here (set by --watchdog).")
    parser.add_argument("--watchdog_floor_s", type=float, default=45.0,
                        help="The watchdog's least stall timeout (seconds).")
    parser.add_argument("--watchdog_first_timeout_s", type=float, default=600.0,
                        help="Seconds a worker has for its first chunk boundary (its start "
                             "included).")
    parser.add_argument("--preempt_grace_s", type=float, default=30.0,
                        help="SIGTERM/SIGINT grace budget: finish the chunk in flight, write a "
                             "chunk-aligned checkpoint and exit with 75; past the budget the "
                             "process exits anyway. 0 disables the handler.")
    _add_telemetry_dir_flag(parser, "the run dir (--artifact_outdir)")
    return parser


def refusal(args, defaults: dict) -> str | None:
    """The one-line reason the port refuses these train flags (``defaults``:
    each flag's default), or None."""
    for dest, item in REFUSED_FLAGS.items():
        value = getattr(args, dest)
        if value != defaults[dest] and value not in ACCEPTED_VALUES.get(dest, ()):
            return f"--{dest} {value!r} is not ported ({item})"
    if args.command in REFUSED_SUBCOMMANDS:
        return (f"the {args.command!r} subcommand is not ported "
                f"({REFUSED_SUBCOMMANDS[args.command]})")
    if args.command in ("workload", "serve", "telemetry"):
        return (f"the {args.command!r} subcommand must come first: "
                f"python -m dib_tpu_torch {args.command} ...")
    return _model_refusal(args)


def _model_refusal(args) -> str | None:
    """What the port refuses in the flags shared by ``train`` and ``serve``."""
    from dib_tpu_torch.data.registry import available_datasets, dataset_loss

    if args.dataset not in available_datasets():
        return f"Unknown dataset {args.dataset!r}; the registry has {available_datasets()}"
    if dataset_loss(args.dataset) == "infonce" and not args.infonce_loss:
        return (f"--dataset {args.dataset} trains with the InfoNCE loss, which needs a y "
                "encoder: add --infonce_loss")
    if args.infonce_loss and args.sweep_beta_ends:
        return f"--infonce_loss with --sweep_beta_ends is not ported ({CONTRASTIVE_SWEEP})"
    if args.optimizer not in ("adam", "sgd"):
        return f"--optimizer {args.optimizer!r}: the port has 'adam' and 'sgd'"
    return None


def _dataset_kwargs(args, device=None) -> dict:
    """The dataset's arguments from the flags (``device``: where the double
    pendulum simulates, when no cache holds its trajectories)."""
    return {
        "device": device,
        "data_path": args.data_path,
        "boolean_random_circuit": args.boolean_random_circuit,
        "boolean_number_input_gates": args.boolean_number_input_gates,
        "pendulum_time_delta": args.pendulum_time_delta,
        "seed": args.seed,
    }


def _bundle_from_args(args, device=None):
    """The dataset bundle from the model flags (``--ib`` and
    ``--infonce_loss`` adjust it, as the trainer expects), made on
    ``device`` where a dataset computes on one."""
    from dib_tpu_torch.data import get_dataset

    bundle = get_dataset(args.dataset, **_dataset_kwargs(args, device))
    if args.ib:
        bundle = bundle.as_vanilla_ib()
    if args.infonce_loss:
        bundle.loss = "infonce"
    return bundle


def _model_from_args(args, bundle, *, device=None, replicas: int | None = None):
    """(model, y_encoder) from the model flags: the one place the flags map
    to an architecture. The weights come from CPU generators: seeded with
    ``--seed``, or for a sweep member r with ``member_seed(seed, r)``."""
    import torch

    from dib_tpu_torch.models import DistributedIBModel, YEncoder
    from dib_tpu_torch.parallel import member_seed

    contrastive = args.infonce_loss
    # n posenc frequencies in the reference convention = n-1 sinusoids
    nfreq = args.number_positional_encoding_frequencies - 1 if args.use_positional_encoding else 0
    compute_dtype = None if args.compute_dtype in (None, "float32") else args.compute_dtype
    generator = (torch.Generator().manual_seed(args.seed) if replicas is None
                 else [torch.Generator().manual_seed(member_seed(args.seed, r))
                       for r in range(replicas)])
    model = DistributedIBModel(
        feature_dimensionalities=tuple(bundle.feature_dimensionalities),
        encoder_hidden=tuple(args.feature_encoder_architecture),
        integration_hidden=tuple(args.integration_network_architecture),
        output_dim=(args.infonce_shared_dimensionality if contrastive
                    else bundle.output_dimensionality),
        embedding_dim=args.feature_embedding_dimension,
        use_positional_encoding=args.use_positional_encoding,
        num_posenc_frequencies=max(nfreq, 0),
        activation=args.activation_fn,
        output_activation=bundle.output_activation,
        compute_dtype=compute_dtype,
        device=device, generator=generator, replicas=replicas,
    )
    y_encoder = None
    if contrastive:
        y_encoder = YEncoder(
            in_dim=int(bundle.y_train.shape[-1]),
            hidden=tuple(args.infonce_y_encoder_architecture),
            shared_dim=args.infonce_shared_dimensionality,
            num_posenc_frequencies=max(nfreq, 0),
            activation=args.activation_fn,
            compute_dtype=compute_dtype,
            generator=generator,
        ).to(next(model.parameters()).device)
    return model, y_encoder


def _train_config(args):
    from dib_tpu_torch.train import TrainConfig

    return TrainConfig(
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        beta_start=args.beta_start,
        beta_end=args.beta_end,
        num_pretraining_epochs=args.number_pretraining_epochs,
        num_annealing_epochs=args.number_annealing_epochs,
        steps_per_epoch=args.steps_per_epoch,
        warmup_steps=args.warmup_steps,
        optimizer=args.optimizer,
        max_val_points=args.max_val_points,
        infonce_similarity=args.infonce_similarity,
        infonce_temperature=args.infonce_temperature,
    )


def matplotlib_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def run(args, device=None) -> dict:
    """Execute a training run from parsed flags on ``device`` (``None``
    means the GPU). Returns the run summary, also written as
    ``run_summary.json``; a preempted run's says ``"status":
    "preempted"``."""
    import numpy as np
    import torch

    from dib_tpu_torch.device import resolve_device
    from dib_tpu_torch.faults import FaultPlan
    from dib_tpu_torch.ops.entropy import sequence_entropy_bits
    from dib_tpu_torch.parallel import BetaSweepTrainer, PerReplicaHook, member_seed
    from dib_tpu_torch.telemetry import open_writer, runtime_manifest, shared_run_id
    from dib_tpu_torch.train import CompressionMatrixHook, DIBTrainer, Every, InfoPerFeatureHook
    from dib_tpu_torch.train.checkpoint import CheckpointHook, DIBCheckpointer, fallback_reporter
    from dib_tpu_torch.train.history import history_extend
    from dib_tpu_torch.train.preempt import PreemptionGuard, TrainingPreempted
    from dib_tpu_torch.train.watchdog import HeartbeatHook

    device = resolve_device(device)
    render = matplotlib_available()
    if args.save_compression_matrices_frequency and not render:
        raise SystemExit("--save_compression_matrices_frequency draws with matplotlib, which "
                         "does not import here; drop the flag")
    bundle = _bundle_from_args(args, device)
    config = _train_config(args)
    outdir = args.artifact_outdir
    os.makedirs(outdir, exist_ok=True)

    cadences = [c for c in (args.save_compression_matrices_frequency,
                            args.info_bounds_frequency) if c]
    hook_every = math.gcd(*cadences, args.checkpoint_frequency if args.checkpoint_dir else 0)

    def make_hooks(subdir: str):
        hooks, info_hook = [], None
        if args.info_bounds_frequency:
            info_hook = InfoPerFeatureHook(seed=args.seed)
            hooks.append(Every(args.info_bounds_frequency, info_hook))
        if args.save_compression_matrices_frequency:
            hooks.append(Every(args.save_compression_matrices_frequency,
                               CompressionMatrixHook(subdir, seed=args.seed)))
        return hooks, info_hook

    # the event stream: into the run dir unless --telemetry-dir says otherwise
    telemetry = open_writer(args.telemetry_dir, outdir, run_id=shared_run_id())
    # DIB_FAULT_PLAN: chunk-boundary faults, fired-once marks in the run dir
    fault_plan = FaultPlan.from_env(state_dir=outdir)

    def grace_expired():
        # the chunk outlived the grace budget: end the stream before the exit
        if telemetry is not None:
            telemetry.run_end(status="preempted", aborted_chunk=True)
            telemetry.close()

    guard = (PreemptionGuard(args.preempt_grace_s, on_grace_expired=grace_expired)
             if args.preempt_grace_s > 0 else None)
    entropy_y = None
    y_arr = np.asarray(bundle.y_train)
    if bundle.loss_is_info_based and not args.infonce_loss and np.allclose(y_arr,
                                                                          np.round(y_arr)):
        # discrete labels only: continuous y would make H(Y) a log2(N) artifact
        entropy_y = sequence_entropy_bits(y_arr)
    summary: dict = {"dataset": args.dataset, "artifacts": []}
    if "source" in bundle.extras:
        summary["data_source"] = bundle.extras["source"]

    info_hooks = {}     # MI hooks by the file their bounds go to, in replica order
    sweep_mode = bool(args.sweep_beta_ends)
    if sweep_mode:
        ends = np.repeat(np.asarray(args.sweep_beta_ends, np.float64), args.sweep_repeats)
        model, _ = _model_from_args(args, bundle, device=device, replicas=len(ends))
        trainer = BetaSweepTrainer(model, bundle, config, args.beta_start, ends, device=device)

        def make_replica_hook(r: int):
            hooks_r, info_hook_r = make_hooks(os.path.join(outdir, f"replica{r}"))
            if info_hook_r is not None:
                info_hooks[f"info_bounds_replica{r}.npz"] = info_hook_r
            return _CombinedHooks(hooks_r)

        hooks = [PerReplicaHook(make_replica_hook)] if cadences else []
        generators = [torch.Generator(device=device).manual_seed(member_seed(args.seed, r))
                      for r in range(len(ends))]
        manifest_extra = {"beta_ends": [float(b) for b in ends], "sweep_engine": "vmap"}
    else:
        model, y_encoder = _model_from_args(args, bundle, device=device)
        trainer = DIBTrainer(model, bundle, config, y_encoder=y_encoder, device=device)
        hooks, info_hook = make_hooks(outdir)
        if info_hook is not None:
            info_hooks["info_bounds.npz"] = info_hook
        generators = torch.Generator(device=device).manual_seed(args.seed)
        manifest_extra = {}
    if args.heartbeat:
        # first: it waits for the chunk itself, so its intervals are chunk wall-clocks
        hooks.insert(0, HeartbeatHook(args.heartbeat))
    if telemetry is not None:
        telemetry.run_start(runtime_manifest(config=config, extra={
            "dataset": args.dataset, "seed": args.seed, **manifest_extra}))

    state = history = remaining = None
    if args.checkpoint_dir:
        ckpt = DIBCheckpointer(args.checkpoint_dir)
        hooks.append(Every(args.checkpoint_frequency, CheckpointHook(ckpt)))
        if ckpt.latest_step is not None:
            # the newest intact step: a step a kill left corrupt is
            # quarantined and the gap trained again
            state, history, generators = ckpt.restore_latest_intact(
                trainer, chunk_size=hook_every, on_fallback=fallback_reporter(
                    telemetry, source="auto-resume",
                    log=lambda msg: print(f"warning: {msg}", file=sys.stderr)))
            done = state.epoch
            remaining = max(config.num_epochs - done, 0)
            capacity, cursor = history["beta"].shape[-1], history["cursor"]
            if cursor + remaining > capacity:
                # a longer budget than the checkpointed run's
                history = history_extend(history, cursor + remaining - capacity)
            summary["resumed_from_epoch"] = done
            print(f"resuming from checkpoint at epoch {done} ({remaining} to go)",
                  file=sys.stderr)

    resumed_from = summary.get("resumed_from_epoch")

    def save_info_bounds():
        """The MI bounds so far, spliced after a resumed run's earlier ones."""
        for name, hook in info_hooks.items():
            if hook.records:
                _save_info_bounds(os.path.join(outdir, name), hook.epochs, hook.bounds_bits,
                                  resumed_from=resumed_from)
                summary["artifacts"].append(os.path.join(outdir, name))

    start = state.epoch if state is not None else 0
    try:
        with guard if guard is not None else contextlib.nullcontext():
            print(f"training: epochs {start} -> {config.num_epochs}, chunks of "
                  f"{hook_every or config.num_epochs}", file=sys.stderr, flush=True)
            # (state, history) are a sweep's (states, histories): passed by position
            state, records = trainer.fit(generators, remaining, hooks, hook_every, state,
                                         history, preempt=guard, telemetry=telemetry,
                                         fault_plan=fault_plan)
    except TrainingPreempted as exc:
        summary.update(status="preempted", preempted_at_epoch=exc.epoch,
                       checkpoint_saved=exc.checkpoint_saved)
        print(f"preempted: {exc}; a relaunch resumes from the chunk-aligned checkpoint",
              file=sys.stderr)
        save_info_bounds()
        if telemetry is not None:
            telemetry.run_end(status="preempted", epoch=exc.epoch)
            telemetry.close()
            summary["events_path"] = telemetry.path
            # the registry's status column tells preempted runs from clean ones
            _register_run_dir(args, os.path.dirname(telemetry.path))
        _write_summary(outdir, summary)
        return summary

    plots = []      # (bits, file name), drawn after the numbers are written
    save_info_bounds()
    if sweep_mode:
        for r, record in enumerate(records):
            bits = record.to_bits(bundle.loss_is_info_based)
            _save_history(os.path.join(outdir, f"history_replica{r}.npz"), bits)
            plots.append((bits, f"distributed_info_plane_replica{r}.png"))
        summary["num_replicas"] = len(ends)
        summary["beta_ends"] = [float(b) for b in ends]
        summary["final_val_loss"] = [float(r.to_bits(bundle.loss_is_info_based).val_loss[-1])
                                     for r in records]
        if trainer.ejected_replicas:
            summary["ejected_replicas"] = {str(r): info
                                           for r, info in trainer.ejected_replicas.items()}
    else:
        bits = records.to_bits(bundle.loss_is_info_based)
        _save_history(os.path.join(outdir, "history.npz"), bits)
        plots.append((bits, "distributed_info_plane.png"))
        summary["final_loss"] = float(bits.loss[-1])
        summary["final_val_loss"] = float(bits.val_loss[-1])
        summary["final_total_kl_bits"] = float(bits.total_kl[-1])
    if telemetry is not None:
        telemetry.run_end(status="ok", final_val_loss=summary.get("final_val_loss"),
                          resumed_from_epoch=summary.get("resumed_from_epoch"))
        telemetry.close()
        summary["events_path"] = telemetry.path
        _register_run_dir(args, os.path.dirname(telemetry.path))
    _write_summary(outdir, summary)
    if render:
        from dib_tpu_torch.viz import save_distributed_info_plane

        for bits, filename in plots:
            summary["artifacts"].append(save_distributed_info_plane(
                bits.kl_per_feature, bits.loss, outdir, entropy_y=entropy_y,
                filename=filename))
    else:
        summary["not_rendered"] = [os.path.join(outdir, filename) for _, filename in plots]
        print(f"matplotlib does not import here: not drawn: {', '.join(summary['not_rendered'])}",
              file=sys.stderr)
    _write_summary(outdir, summary)
    return summary


def _save_history(path: str, bits) -> None:
    import numpy as np

    np.savez(path, beta=bits.beta, kl_per_feature=bits.kl_per_feature, loss=bits.loss,
             val_loss=bits.val_loss, metric=bits.metric, val_metric=bits.val_metric)


def _write_summary(outdir: str, summary: dict) -> None:
    with open(os.path.join(outdir, "run_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
        f.write("\n")


def _save_info_bounds(path: str, epochs, bounds_bits, resumed_from: int | None = None) -> None:
    """Write an MI-bound trajectory npz, merging with a pre-crash file.

    After a resume the fresh hooks hold only the records made since, while
    the same directory may hold the interrupted run's npz: its strictly
    earlier epochs are prepended, and ``resumed_from_epoch`` records the
    splice point.
    """
    import zipfile

    import numpy as np

    epochs = np.asarray(epochs)
    bounds_bits = np.asarray(bounds_bits)
    extras = {}
    if resumed_from is not None:
        extras["resumed_from_epoch"] = np.asarray(resumed_from)
        if os.path.exists(path) and epochs.size:
            try:
                with np.load(path) as prev:
                    prev_epochs = np.asarray(prev["epochs"])
                    prev_bounds = np.asarray(prev["bounds_bits"])
                keep = prev_epochs < epochs.min()
                if keep.any() and prev_bounds.shape[1:] == bounds_bits.shape[1:]:
                    epochs = np.concatenate([prev_epochs[keep], epochs])
                    bounds_bits = np.concatenate([prev_bounds[keep], bounds_bits])
            except (OSError, KeyError, ValueError, zipfile.BadZipFile) as exc:
                print(f"warning: discarding unreadable prior trajectory {path}: {exc}",
                      file=sys.stderr)
    np.savez(path, epochs=epochs, bounds_bits=bounds_bits, **extras)


class _CombinedHooks:
    """Several serial hooks as one callable (for ``PerReplicaHook``)."""

    def __init__(self, hooks: Sequence):
        self.hooks = list(hooks)

    def check(self, trainer):
        for hook in self.hooks:
            if hasattr(hook, "check"):
                hook.check(trainer)

    def __call__(self, trainer, state, epoch: int):
        for hook in self.hooks:
            hook(trainer, state, epoch)


# ---------------------------------------------------------------- workloads
# ``python -m dib_tpu_torch workload <name>``: the flagship drivers, with
# ``--set field=value`` overrides of the workload's config dataclass.

def _coerce(value: str):
    import ast

    lowered = value.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _parse_sets(pairs: Sequence[str]) -> dict:
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects field=value, got {pair!r}")
        key, value = pair.split("=", 1)
        out[key] = _coerce(value)
    return out


def _apply_config(config_cls, overrides: dict):
    import dataclasses

    fields = {f.name for f in dataclasses.fields(config_cls)}
    bad = set(overrides) - fields
    if bad:
        raise SystemExit(f"Unknown {config_cls.__name__} field(s) {sorted(bad)}; "
                         f"valid: {sorted(fields)}")
    return config_cls(**overrides)


def _check_kwargs(fn, overrides: dict) -> dict:
    """Validate --set names against a keyword-style workload signature
    (``seed`` comes from --seed, ``device`` from the caller)."""
    import inspect

    valid = set(inspect.signature(fn).parameters) - {"seed", "device"}
    if "seed" in overrides:
        raise SystemExit("Use --seed, not --set seed=...")
    bad = set(overrides) - valid
    if bad:
        raise SystemExit(f"Unknown {fn.__name__} argument(s) {sorted(bad)}; "
                         f"valid: {sorted(valid)}")
    return overrides


def _json_safe(x, depth: int = 0):
    """Compact JSON view of a workload result (arrays and modules -> labels)."""
    import dataclasses

    import numpy as np
    import torch

    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    if isinstance(x, torch.Tensor):
        return f"<tensor {list(x.shape)} {str(x.dtype).replace('torch.', '')}>"
    if isinstance(x, (torch.nn.Module, torch.optim.Optimizer)):
        return f"<{type(x).__name__}>"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _json_safe({f.name: getattr(x, f.name) for f in dataclasses.fields(x)}, depth)
    if isinstance(x, dict) and depth < 2:
        return {str(k): _json_safe(v, depth + 1) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and len(x) <= 12:
        values = [_json_safe(v, depth + 1) for v in x]
        if all(isinstance(v, (bool, int, float, str, type(None))) for v in values):
            return values
    try:
        arr = np.asarray(x)
        if arr.dtype != object:
            return f"<array {list(arr.shape)} {arr.dtype}>"
    except (ValueError, TypeError, RuntimeError):
        pass
    return f"<{type(x).__name__}>"


def workload_main(argv: Sequence[str], device=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dib_tpu_torch workload",
        description="Run a paper workload end to end.")
    parser.add_argument("name", choices=["boolean", "amorphous", "amorphous_protocols", "chaos",
                                         "chaos_state_sweep", "characterization",
                                         "radial_shells"],
                        help=f"The port has {', '.join(PORTED_WORKLOADS)}; the others are "
                             f"refused ({WORKLOADS}).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--outdir", default=None, help="Artifact directory.")
    _add_telemetry_dir_flag(parser, "--outdir when given, else none")
    parser.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE",
                        help="Override a workload config field or keyword (repeatable), "
                             "e.g. --set num_steps=1000")
    args = parser.parse_args(argv)
    if args.name not in PORTED_WORKLOADS:
        parser.error(f"workload {args.name!r} is not ported ({WORKLOADS})")
    if args.outdir and args.name == "boolean":
        # it writes no artifact file: a silently ignored --outdir wastes a long run
        raise SystemExit(f"workload {args.name!r} does not write artifacts; drop --outdir "
                         "and read the JSON summary (or use the Python API)")
    overrides = _parse_sets(args.set)

    from dib_tpu_torch import workloads as wl
    from dib_tpu_torch.telemetry import open_writer, runtime_manifest, shared_run_id

    # the event stream brackets the run (run_start, run_end), into --outdir by default
    telemetry = open_writer(args.telemetry_dir, args.outdir, run_id=shared_run_id())

    kwargs = {"outdir": args.outdir} if args.outdir else {}
    render = matplotlib_available()
    if not render:
        print("matplotlib does not import here: the workload draws nothing (render=False)",
              file=sys.stderr)
    def start(config=None):
        if telemetry is not None:
            telemetry.run_start(runtime_manifest(config=config, extra={
                "workload": args.name, "seed": args.seed}))

    def finish():
        if telemetry is not None:
            telemetry.run_end(status="ok")
            telemetry.close()
            _register_run_dir(args, os.path.dirname(telemetry.path))

    if args.name == "characterization":
        start()
        results = wl.run_characterization(
            seed=args.seed, device=device,
            **_check_kwargs(wl.run_characterization, overrides))
        if args.outdir and render:
            wl.save_characterization_plots(results, args.outdir)
        finish()
        # one serialization per cell: the sweep is the product
        print(json.dumps({"results": [_json_safe(r) for r in results]}))
        return 0
    if args.name == "amorphous":
        config = _apply_config(wl.AmorphousWorkloadConfig, overrides)
        start(config)
        result = wl.run_amorphous_workload(args.seed, config, device=device, render=render,
                                           **kwargs)
    elif args.name == "boolean":
        config = _apply_config(wl.BooleanWorkloadConfig, overrides)
        start(config)
        result = wl.run_boolean_workload(args.seed, config, telemetry=telemetry, device=device)
    elif args.name == "radial_shells":
        config = _apply_config(wl.RadialShellsConfig, overrides)
        start(config)
        result = wl.run_radial_shells_workload(args.seed, config, device=device, render=render,
                                               **kwargs)
    else:
        import dataclasses

        fields = {f.name for f in dataclasses.fields(wl.AmorphousWorkloadConfig)}
        cfg = {k: v for k, v in overrides.items() if k in fields}
        # the other --set names go to run_amorphous_protocols and the dataset
        rest = {k: v for k, v in overrides.items() if k not in fields}
        config = _apply_config(wl.AmorphousWorkloadConfig, cfg) if cfg else None
        start(config)
        result = wl.run_amorphous_protocols(args.seed, config=config, device=device,
                                            render=render, **rest, **kwargs)
    finish()
    print(json.dumps(_json_safe(result)))
    return 0


# ---------------------------------------------------------------- serving
# ``python -m dib_tpu_torch serve``: a checkpoint of ``train`` behind the JSON
# HTTP API of dib_tpu_torch.serve, with the JAX package's flags and defaults.

class _ServeParser(argparse.ArgumentParser):
    """Refuses what the port does not serve as it parses."""

    def parse_args(self, args=None, namespace=None):
        parsed = super().parse_args(args, namespace)
        problem = serve_refusal(parsed)
        if problem:
            self.error(problem)
        return parsed


def serve_parser() -> argparse.ArgumentParser:
    parser = _ServeParser(
        prog="dib_tpu_torch serve",
        description="Serve a checkpoint of `dib_tpu_torch train` over a JSON HTTP API on the "
                    "GPU.",
    )
    _add_model_flags(parser)
    parser.add_argument("--checkpoint_dir", type=str, required=True,
                        help="DIBCheckpointer directory holding the trained run (its "
                             "manifest's structure and digests are verified).")
    # restore-template flags: the checkpoint's optimizer state must restore
    # into a structurally identical template
    parser.add_argument("--optimizer", type=str, default="adam")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--beta_start", type=float, default=1e-4)
    parser.add_argument("--beta_end", type=float, default=3e0)
    parser.add_argument("--sweep_beta_ends", type=float, nargs="+", default=None,
                        help="Serve a SWEEP checkpoint: one β-labeled replica per end-beta "
                             "(x --sweep_repeats); clients select with {\"beta\": x}.")
    parser.add_argument("--sweep_repeats", type=int, default=1)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8100,
                        help="0 binds an ephemeral port (printed on stdout).")
    parser.add_argument("--buckets", type=int, nargs="+", default=None,
                        help="Padded batch sizes (default: the engine's DEFAULT_BUCKETS, "
                             "1 8 32 128).")
    parser.add_argument("--max_batch", type=int, default=32)
    parser.add_argument("--max_wait_ms", type=float, default=2.0)
    parser.add_argument("--max_queue", type=int, default=256)
    parser.add_argument("--eject_after", type=int, default=3,
                        help="Consecutive dispatch failures before a replica is ejected "
                             "from routing.")
    parser.add_argument("--probe_after_s", type=float, default=5.0,
                        help="Rest period before an ejected replica is probed for "
                             "re-admission (0 disables the probe thread).")
    parser.add_argument("--probe_timeout_s", type=float, default=5.0,
                        help="A re-admission probe slower than this counts as failed.")
    parser.add_argument("--num_devices", type=int, default=0,
                        help="CUDA devices to replicate over (0 = all; ignored when serving "
                             "a sweep).")
    parser.add_argument("--prefork", type=int, default=0,
                        help="Spawn this many FULL server processes sharing one port via "
                             "SO_REUSEPORT (the kernel balances connections). 0 = single "
                             "process. The parent supervises and respawns dead workers.")
    parser.add_argument("--reuse_port", action="store_true",
                        help="Bind with SO_REUSEPORT (set automatically on prefork workers).")
    parser.add_argument("--workers", type=int, default=0,
                        help="Run this many replica engines in worker SUBPROCESSES, each on "
                             "the GPU, behind the pipe request plane (0 = in-process "
                             "replicas; ignored when serving a sweep).")
    parser.add_argument("--model_name", type=str, default="default",
                        help="Zoo name this checkpoint serves under (clients select with "
                             "{\"model\": name}).")
    parser.add_argument("--quota_rps", type=float, default=0.0,
                        help="Per-tenant token-bucket rate (requests/s); a tenant over "
                             "budget gets 429 + Retry-After (0 disables quotas).")
    parser.add_argument("--quota_burst", type=float, default=None,
                        help="Per-tenant burst headroom (default: max(quota_rps, 1)).")
    parser.add_argument("--admission_limit", type=int, default=0,
                        help="Global bound on in-flight requests; beyond it requests shed "
                             "with 503 + Retry-After (0 disables).")
    parser.add_argument("--response_cache", type=int, default=0,
                        help="Response-cache capacity (entries) for repeated (input, beta, "
                             "checkpoint) queries (0 disables).")
    parser.add_argument("--exec_cache", type=int, default=0,
                        help="Not ported: the engine runs eagerly and holds no per-bucket "
                             f"executable; refused when > 0 ({SERVE_GRAPHS}).")
    parser.add_argument("--serve_seconds", type=float, default=0.0,
                        help="Auto-shutdown after this many seconds (0 = run until "
                             "SIGINT/SIGTERM).")
    parser.add_argument("--outdir", type=str, default="./serve_artifacts/",
                        help="Run directory for the serving event stream (created and named "
                             "in the hello line).")
    _add_telemetry_dir_flag(parser, "--outdir")
    return parser


def serve_refusal(args) -> str | None:
    """The one-line reason the port refuses these serve flags, or None."""
    if args.exec_cache > 0:
        return f"--exec_cache {args.exec_cache} is not ported ({SERVE_GRAPHS})"
    return _model_refusal(args)


def _serve_config(args):
    """The restore template's training config from the serve flags."""
    from dib_tpu_torch.train import TrainConfig

    return TrainConfig(batch_size=args.batch_size, beta_start=args.beta_start,
                       beta_end=args.beta_end, optimizer=args.optimizer,
                       warmup_steps=args.warmup_steps)


def _entry_command(device) -> list[str]:
    """The command of a worker process (prefork servers, the watchdog's
    training workers), before its subcommand: ``python -m dib_tpu_torch``
    (the GPU), or, when the entry point was given a device, ``main`` with
    that device as its Python argument."""
    if device is None:
        return [sys.executable, "-m", "dib_tpu_torch"]
    return [sys.executable, "-c", "import sys; from dib_tpu_torch.cli import main; "
            f"sys.exit(main(sys.argv[1:], device={str(device)!r}))"]


def serve_main(argv: Sequence[str], device=None) -> int:
    """``python -m dib_tpu_torch serve``; ``device`` (a Python argument, not
    a flag) is where the engines run, ``None`` meaning every CUDA device
    (``--num_devices`` of them); without a card it raises."""
    argv = list(argv)
    if argv and argv[0] == "top":
        # attaches to a RUNNING fleet over HTTP: no serve flags, no torch
        from dib_tpu_torch.serve.top import serve_top_main

        return serve_top_main(argv[1:])
    args = serve_parser().parse_args(argv)
    if args.prefork > 0:
        from dib_tpu_torch.serve.prefork import supervise_prefork
        from dib_tpu_torch.telemetry.context import ensure_context

        # every worker's event stream carries the fleet's one trace_id
        ensure_context("serve").activate()
        return supervise_prefork(argv, prefork=args.prefork, host=args.host, port=args.port,
                                 outdir=args.outdir, serve_seconds=args.serve_seconds,
                                 command=(*_entry_command(device), "serve"))

    import signal
    import threading

    import numpy as np

    from dib_tpu_torch.device import resolve_device
    from dib_tpu_torch.parallel import BetaSweepTrainer
    from dib_tpu_torch.serve import (
        DEFAULT_BUCKETS,
        DIBServer,
        ModelZoo,
        TenantQuotas,
        pool_router,
    )
    from dib_tpu_torch.serve.replicas import local_devices
    from dib_tpu_torch.telemetry import (
        MetricsRegistry,
        Tracer,
        open_writer,
        runtime_manifest,
        shared_run_id,
    )
    from dib_tpu_torch.train import DIBTrainer
    from dib_tpu_torch.train.checkpoint import DIBCheckpointer

    requested, device = device, resolve_device(device)
    bundle = _bundle_from_args(args, device)
    config = _serve_config(args)
    buckets = list(args.buckets or DEFAULT_BUCKETS)
    os.makedirs(args.outdir, exist_ok=True)
    # the event stream: into --outdir unless --telemetry-dir says otherwise
    telemetry = open_writer(args.telemetry_dir, args.outdir, run_id=shared_run_id())
    registry = MetricsRegistry()
    # no stream, no spans: a serve without one keeps no span timings either
    tracer = Tracer(telemetry) if telemetry is not None else None
    if telemetry is not None:
        telemetry.run_start(runtime_manifest(config=config, extra={
            "mode": "serve", "dataset": args.dataset,
            "checkpoint_dir": os.path.abspath(args.checkpoint_dir),
            "buckets": [int(b) for b in buckets],
            "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
            "sweep": bool(args.sweep_beta_ends), "workers": args.workers,
            "quota_rps": args.quota_rps,
            "admission_limit": args.admission_limit,
            "response_cache": args.response_cache,
            "exec_cache": args.exec_cache,   # always 0: the port has no executable cache
        }))
    zoo = ModelZoo(response_capacity=args.response_cache or None, telemetry=telemetry,
                   registry=registry)
    router_kwargs = dict(
        batch_buckets=buckets, telemetry=telemetry, registry=registry, tracer=tracer,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        eject_after=args.eject_after, probe_after_s=args.probe_after_s,
        probe_timeout_s=args.probe_timeout_s,
    )
    if args.sweep_beta_ends:
        ends = np.repeat(np.asarray(args.sweep_beta_ends, np.float64), args.sweep_repeats)
        model, _ = _model_from_args(args, bundle, device=device, replicas=len(ends))
        sweep = BetaSweepTrainer(model, bundle, config, args.beta_start, ends, device=device)
        router = zoo.add_sweep_checkpoint(args.model_name, args.checkpoint_dir, sweep,
                                          **router_kwargs)
    else:
        model, y_encoder = _model_from_args(args, bundle, device=device)
        trainer = DIBTrainer(model, bundle, config, y_encoder=y_encoder, device=device)
        state, _, _ = DIBCheckpointer(args.checkpoint_dir).restore(trainer)
        if args.workers > 0:
            # engines in worker subprocesses, each on the device, behind the
            # pipe request plane: request handling leaves this GIL
            router = pool_router(state.params["model"], args.workers, device=device,
                                 **router_kwargs)
            zoo.register(args.model_name, router, checkpoint_dir=args.checkpoint_dir)
        else:
            devices = local_devices(requested)
            if requested is None and args.num_devices > 0:
                devices = devices[:args.num_devices]
            router = zoo.add_params(args.model_name, state.params["model"], devices=devices,
                                    checkpoint_dir=args.checkpoint_dir, **router_kwargs)

    quotas = TenantQuotas(args.quota_rps, args.quota_burst) if args.quota_rps > 0 else None
    server = DIBServer(zoo, host=args.host, port=args.port, telemetry=telemetry,
                       registry=registry, tracer=tracer, quotas=quotas,
                       admission_limit=args.admission_limit or None,
                       reuse_port=args.reuse_port)
    stop = threading.Event()
    handlers = {}
    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGINT, signal.SIGTERM):
            handlers[signum] = signal.signal(signum, lambda *_: stop.set())
    try:
        server.start()
        # machine-readable first line: callers read the bound port from here
        print(json.dumps({
            "serving": server.url, "port": server.port,
            "replicas": len(router.entries), "run_dir": args.outdir,
            "models": zoo.names(), "workers": args.workers,
        }), flush=True)
        stop.wait(args.serve_seconds if args.serve_seconds > 0 else None)
    finally:
        server.close()
        for signum, handler in handlers.items():
            signal.signal(signum, handler)
    if telemetry is not None:
        # after close(): the stream now ends with its metrics rollup and run_end
        _register_run_dir(args, os.path.dirname(telemetry.path))
    counters = registry.snapshot()["counters"]
    print(json.dumps({
        "served_requests": counters.get("serve.requests.ok", 0),
        "batches": counters.get("serve.batches", 0),
    }), flush=True)
    return 0


def main(argv: Sequence[str] | None = None, device=None) -> int:
    """``python -m dib_tpu_torch``; ``device`` (a Python argument, not a
    flag) is where training or serving runs, ``None`` meaning the GPU."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("workload", "serve"):
        entry = workload_main if argv[0] == "workload" else serve_main
        try:
            return entry(argv[1:], device)
        except Exception as exc:
            # a crashed run's stream ends with run_end(status="error")
            from dib_tpu_torch.telemetry import finalize_crashed

            finalize_crashed(exc, log=lambda msg: print(msg, file=sys.stderr))
            raise
    if argv and argv[0] == "telemetry":
        # file analysis on the host: no device, no torch
        from dib_tpu_torch.telemetry.summary import telemetry_main

        return telemetry_main(argv[1:])
    if argv and argv[0] in REFUSED_SUBCOMMANDS:
        print(f"dib_tpu_torch: the {argv[0]!r} subcommand is not ported "
              f"({REFUSED_SUBCOMMANDS[argv[0]]})", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    if args.watchdog:
        return _watchdog_main(args, argv, device)
    try:
        summary = run(args, device=device)
    except BaseException as exc:
        # a crashed run's stream ends with run_end(status="error")
        from dib_tpu_torch.telemetry import finalize_crashed

        finalize_crashed(exc, log=lambda msg: print(msg, file=sys.stderr))
        raise
    print(json.dumps(summary))
    if summary.get("status") == "preempted":
        from dib_tpu_torch.train.preempt import PREEMPT_EXIT_CODE

        return PREEMPT_EXIT_CODE
    return 0


def _watchdog_main(args, argv: Sequence[str], device=None) -> int:
    """``train --watchdog``: this process becomes a supervisor that never
    touches the device; it relaunches the same command without the flag
    as a worker with a checkpoint directory and a heartbeat
    (``train/watchdog.py``). The run id and the trace context are pinned
    in the environment, so the supervisor's mitigations and every worker
    launch write one run into one event stream; liveness comes from that
    stream's heartbeats when it is written. Prints ``{"watchdog": report}``
    and exits 0 once a worker finished."""
    from dib_tpu_torch.telemetry import open_writer, shared_run_id
    from dib_tpu_torch.telemetry.context import ensure_context
    from dib_tpu_torch.train.watchdog import WatchdogConfig, supervise_self

    run_id = shared_run_id()
    os.environ["DIB_TELEMETRY_RUN_ID"] = run_id
    ctx = ensure_context("train")
    ctx.activate()
    telemetry = open_writer(args.telemetry_dir, args.artifact_outdir, run_id=run_id,
                            process_index=0, tags={"src": "supervisor"}, ctx=ctx)
    try:
        result = supervise_self(
            _entry_command(device), argv, outdir=args.artifact_outdir,
            watchdog_flag="--watchdog", heartbeat_flag="--heartbeat",
            checkpoint_flag="--checkpoint_dir", heartbeat=args.heartbeat,
            checkpoint_dir=args.checkpoint_dir,
            config=WatchdogConfig(first_beat_timeout_s=args.watchdog_first_timeout_s,
                                  floor_s=args.watchdog_floor_s),
            telemetry=telemetry,
            events_path=telemetry.path if telemetry is not None else None)
    finally:
        if telemetry is not None:
            telemetry.close()
    if telemetry is not None:
        # supersedes the worker's own registration with the supervised view
        _register_run_dir(args, os.path.dirname(telemetry.path))
    print(json.dumps({"watchdog": result}))
    return 0 if result["returncode"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
