"""How often ``telemetry compare`` calls two clean serving runs a regression.

Trains the CLI's default ``DistributedIBModel`` for 1 + 1 epochs with a
checkpoint, then runs rounds of three clean ``python -m dib_tpu_torch
serve`` processes over it, each writing its event stream, and one client
at concurrency 1 sending predicts of 1 row to the three in turns
(``chip_smoke.py``'s ``turns``); within each round every ordered pair of
runs goes through ``compare`` at ``--threshold``. With ``--in-process`` the
three servers are ``DIBServer`` objects in this process
(``chip_smoke.py``'s ``in_process_serve``, as phase 15 runs them). Prints each
round's phase p99s, each pair's worst phase, and the count of pairs that
regressed. Run from the checkout's root (it loads ``chip_smoke.py`` from
there)::

    python -m dib_tpu_torch.scripts.compare_noise --requests 4000 --rounds 3
    python -m dib_tpu_torch.scripts.compare_noise --requests 4000 --rounds 3 --in-process

``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def serve_in_turns(chip_smoke, dirs, checkpoint_dir, x, requests):
    """One ``python -m dib_tpu_torch serve`` process over ``checkpoint_dir``
    per directory (its ``--outdir``), sent ``requests`` predicts each in
    turns, then SIGTERM."""
    procs = []
    try:
        for directory in dirs:
            procs.append(chip_smoke.ServeProcess(os.path.basename(directory), [
                "--checkpoint_dir", checkpoint_dir, "--port", "0", "--outdir", directory]))
        for proc in procs:
            proc.wait_hello()
        chip_smoke.turns({proc.url: requests for proc in procs}, x)
        for proc in procs:
            code, _ = proc.stop()
            if code != 0:
                raise RuntimeError(f"serve {proc.label}: SIGTERM gave exit {code}")
    finally:
        for proc in procs:
            proc.kill()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m dib_tpu_torch.scripts.compare_noise")
    parser.add_argument("--requests", type=int, default=4000, help="Predicts per run.")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--in-process", action="store_true",
                        help="Serve from this process instead of serve processes.")
    parser.add_argument("--device", default=None, help="'cpu', or the GPU by default.")
    args = parser.parse_args(argv)

    import numpy as np

    from dib_tpu_torch import cli
    from dib_tpu_torch.device import card_line
    from dib_tpu_torch.serve import InferenceEngine
    from dib_tpu_torch.telemetry.summary import compare, summarize

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke.CLI_COMMAND = cli._entry_command(args.device)
    print(card_line() if args.device is None else args.device)
    regressions = pairs = 0
    with tempfile.TemporaryDirectory(prefix="compare_noise_") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        train = cli.build_parser().parse_args([
            "train", "--artifact_outdir", os.path.join(tmp, "run"), "--telemetry-dir", "",
            "--number_pretraining_epochs", "1", "--number_annealing_epochs", "1",
            "--checkpoint_dir", ckpt, "--checkpoint_frequency", "1"])
        cli.run(train, device=args.device)
        bundle = cli._bundle_from_args(train)
        x = np.asarray(bundle.x_valid, np.float32)
        engine = None
        if args.in_process:
            model, _ = cli._model_from_args(train, bundle, device=args.device)
            engine = InferenceEngine(model, device=args.device)
        for rnd in range(args.rounds):
            dirs = [os.path.join(tmp, f"{rnd}_{k}") for k in range(3)]
            t0 = time.perf_counter()
            if args.in_process:
                chip_smoke.in_process_serve({d: (0.0, args.requests) for d in dirs}, engine, x)
            else:
                serve_in_turns(chip_smoke, dirs, ckpt, x, args.requests)
            records = [summarize(d) for d in dirs]
            print(f"round {rnd}: {time.perf_counter() - t0:.1f} s; phase p99 ms per run: "
                  + json.dumps([{p: v["p99_ms"] for p, v in r["serving"]["phases"].items()}
                                for r in records]), flush=True)
            for i, j in itertools.permutations(range(3), 2):
                report, regressed = compare(records[i], records[j], threshold=args.threshold)
                phases = {key[len("serving_phase_"):-len("_p99_ms")]: (row["a"], row["b"],
                                                                     row.get("rel"))
                          for key, row in report["fields"].items()
                          if key.startswith("serving_phase_")}
                worst = max(phases.items(), key=lambda kv: kv[1][2] or 0.0)
                pairs += 1
                regressions += regressed
                print(f"round {rnd} {i}->{j}: regressed {regressed}; worst phase (a, b, rel) "
                      f"{worst}", flush=True)
    print(f"{regressions} of {pairs} ordered pairs of clean runs regressed at --threshold "
          f"{args.threshold} ({args.requests} requests per run, "
          f"{'in this process' if args.in_process else 'serve processes'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
