"""Where a β-sweep member and its serial run part, and why.

Trains the members of the CLI's sweep (``python -m dib_tpu_torch train
--sweep_beta_ends 0.03 0.1 0.3 1.0 --sweep_repeats 2`` at the CLI's
defaults, 4 + 8 epochs of 8 steps) without hooks, from the initial weights
and draws of their member seeds, and prints each comparison's per-epoch
largest relative history row difference and its largest leaf difference
relative to the leaf's norm:

  - the stack of eight against a serial run of each member, in float32 and
    in float64 (the port's float32 output layers computed in float64 too);
  - the stack in reverse order, and stacks of eight copies of member 7 and
    of member 0, each slot against the same member's slot of the stack of
    eight (bit for bit: does another member move it?);
  - each member's serial run against itself with its first integration
    kernel scaled by (1 + 2^-23) and (1 + 2^-20): how far the trajectory
    carries one ulp.

``--deterministic`` runs the stack and member 7 under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints the
warnings (set ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before the process
starts). It runs on the GPU unless ``--device cpu`` is given.

    python -m dib_tpu_torch.scripts.sweep_drift [--device cpu] [--deterministic]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
import warnings

import numpy as np
import torch

HISTORY_ROWS = ("beta", "kl_per_feature", "loss", "val_loss")
SWEEP_FLAGS = ["--sweep_beta_ends", "0.03", "0.1", "0.3", "1.0", "--sweep_repeats", "2"]
CUTS = ["--number_pretraining_epochs", "4", "--number_annealing_epochs", "8"]
ULP = 2.0 ** -23


def in_float64(trainer):
    """``trainer`` with its model and data in float64, the output layers
    that the port computes in float32 included; with float64 as the
    default type its draws are float64 too."""
    from dib_tpu_torch.models.mlp import Dense

    trainer.model.double()
    for module in trainer.model.modules():
        if isinstance(module, Dense) and module.dtype is not None:
            module.dtype = torch.float64
    for name in ("_x_train", "_y_train", "_x_valid", "_y_valid"):
        setattr(trainer, name, getattr(trainer, name).double())
    return trainer


class CliMembers:
    """Members of the CLI's sweep given by ``argv`` (``train`` flags with
    ``--sweep_beta_ends``) trained without hooks, from the initial weights
    and draws of their member seeds and with their endpoints, alone
    (``serial``) or as one stack (``stack``), in float32 or float64. Each
    run gives, per member, (history in bits, {leaf: float64 tensor on the
    CPU})."""

    def __init__(self, argv, device):
        from dib_tpu_torch import cli

        self.cli = cli
        self.device = device
        self.args = cli.build_parser().parse_args(argv)
        self.bundle = cli._bundle_from_args(self.args)
        self.ends = np.repeat(np.asarray(self.args.sweep_beta_ends, np.float64),
                              self.args.sweep_repeats)

    def member_args(self, r):
        from dib_tpu_torch.parallel import member_seed

        args = copy.copy(self.args)
        args.seed, args.beta_end = member_seed(self.args.seed, r), float(self.ends[r])
        return args

    def model(self, r):
        return self.cli._model_from_args(self.member_args(r), self.bundle, device="cpu")[0]

    def _fit(self, trainer, generators, dtype):
        if dtype == torch.float64:
            in_float64(trainer)
        torch.set_default_dtype(dtype)
        try:
            return trainer.fit(generators)[1]
        finally:
            torch.set_default_dtype(torch.float32)

    def _bits(self, record):
        return record.to_bits(self.bundle.loss_is_info_based)

    def serial(self, r, dtype=torch.float32, nudge=0.0):
        """Member r alone; ``nudge`` scales its first integration kernel by
        (1 + nudge) first."""
        from dib_tpu_torch.train import DIBTrainer

        model = self.model(r)
        if nudge:
            with torch.no_grad():
                model.integration.layers[0].kernel.mul_(1.0 + nudge)
        args = self.member_args(r)
        trainer = DIBTrainer(model, self.bundle, self.cli._train_config(args), device=self.device)
        history = self._fit(trainer, torch.Generator(device=self.device).manual_seed(args.seed),
                            dtype)
        return self._bits(history), {name: value.detach().double().cpu()
                                     for name, value in model.state_dict().items()}

    def stack(self, members, dtype=torch.float32):
        """Members ``members`` (a list, repeats allowed) as one stack."""
        from dib_tpu_torch.parallel import BetaSweepTrainer, member_seed

        stacked, _ = self.cli._model_from_args(self.args, self.bundle, device="cpu",
                                               replicas=len(members))
        alone = [self.model(r).state_dict() for r in members]
        stacked.load_state_dict({
            name: (torch.cat if name.startswith("encoders.") else torch.stack)(
                [state[name] for state in alone]) for name in alone[0]})
        sweep = BetaSweepTrainer(stacked, self.bundle, self.cli._train_config(self.args),
                                 self.args.beta_start, self.ends[list(members)],
                                 device=self.device)
        records = self._fit(sweep, [torch.Generator(device=self.device).manual_seed(
            member_seed(self.args.seed, r)) for r in members], dtype)
        state = stacked.state_dict()
        return [(self._bits(record),
                 {name: stacked.member_values(name, value, i).detach().double().cpu()
                  for name, value in state.items()}) for i, record in enumerate(records)]

    def accuracy_counts(self) -> dict:
        """Predictions behind each accuracy row: one epoch's training rows,
        the validation rows."""
        steps = self.args.steps_per_epoch or -(-len(self.bundle.x_train) // self.args.batch_size)
        return {"metric": steps * self.args.batch_size,
                "val_metric": min(len(self.bundle.x_valid), self.args.max_val_points)}


def rel_rows(got, want):
    """Per-row largest relative difference of two [T, ...] series."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.where(got == want, 0.0, np.abs(got - want) / np.maximum(np.abs(want), 1e-30))
    return diff.reshape(len(diff), -1).max(axis=1)


def leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's difference relative to its norm in ``want``."""
    return {name: ((got[name] - w).norm() / w.norm().clamp_min(1e-30)).item()
            for name, w in want.items()}


def member_errors(got, want, counts):
    """(per-epoch largest relative row difference, {leaf: difference
    relative to its norm}, accuracy predictions flipped per epoch) of run
    ``got`` against ``want``, each (history, leaves)."""
    (got_history, got_leaves), (want_history, want_leaves) = got, want
    rows = np.max([rel_rows(getattr(got_history, n), getattr(want_history, n))
                   for n in HISTORY_ROWS], axis=0)
    flips = np.max([np.rint(np.abs(np.asarray(getattr(got_history, n), np.float64)
                                   - np.asarray(getattr(want_history, n), np.float64)) * count)
                    for n, count in counts.items()], axis=0)
    return rows, leaf_errors(got_leaves, want_leaves), [int(f) for f in flips]


def same_run(a, b) -> bool:
    """Two runs equal bit for bit: every history field and leaf."""
    return all(np.array_equal(getattr(a[0], n), getattr(b[0], n))
               for n in HISTORY_ROWS + ("metric", "val_metric")) and \
        all(torch.equal(a[1][name], b[1][name]) for name in a[1])


def report(label, got, want, counts):
    rows, errs, flips = member_errors(got, want, counts)
    print(f"{label}: rows per epoch {[float(f'{e:.3g}') for e in rows]} (max {rows.max():.3e}); "
          f"leaves up to {max(errs.values()):.3e}; accuracy flips per epoch {flips}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the GPU when left out")
    parser.add_argument("--deterministic", action="store_true")
    opts = parser.parse_args(argv)
    from dib_tpu_torch.device import card_line, resolve_device

    device = resolve_device(opts.device)
    members = CliMembers(["train", "--dataset", "boolean_circuit", "--artifact_outdir",
                          "unused", *CUTS, *SWEEP_FLAGS], device)
    counts = members.accuracy_counts()
    print(card_line() if device.type == "cuda" else "device: cpu", flush=True)
    t0 = time.perf_counter()
    if opts.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            natural, serial = members.stack(list(range(8))), members.serial(7)
        print(f"deterministic algorithms: {len(caught)} warnings "
              f"{json.dumps(sorted({str(w.message)[:300] for w in caught}))}")
        report(f"[{device.type} float32, deterministic] stack slot 7 vs serial member 7",
               natural[7], serial, counts)
        return 0
    for dtype in (torch.float32, torch.float64):
        tag = f"[{device.type} {str(dtype)[len('torch.'):]}]"
        serials = [members.serial(r, dtype) for r in range(8)]
        natural = members.stack(list(range(8)), dtype)
        for r in range(8):
            report(f"{tag} stack slot {r} (end {members.ends[r]}) vs serial member {r}",
                   natural[r], serials[r], counts)
        reverse = members.stack(list(range(7, -1, -1)), dtype)
        print(f"{tag} reversed stack: member r in slot 7 - r equals slot r of the stack "
              f"bit for bit: {[same_run(reverse[7 - r], natural[r]) for r in range(8)]}")
        for r in (7, 0):
            copies = members.stack([r] * 8, dtype)
            print(f"{tag} stack of eight copies of member {r}: each slot equals slot {r} of "
                  f"the stack bit for bit: {[same_run(run, natural[r]) for run in copies]}")
        for r in range(8):
            for nudge, name in ((ULP, "2^-23"), (ULP * 8, "2^-20")):
                report(f"{tag} serial member {r}, first integration kernel x (1 + {name}), vs "
                       f"serial member {r}", members.serial(r, dtype, nudge), serials[r], counts)
        print(f"{tag} serial member 7 twice equal bit for bit: "
              f"{same_run(members.serial(7, dtype), serials[7])}; "
              f"{time.perf_counter() - t0:.1f} s so far", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
