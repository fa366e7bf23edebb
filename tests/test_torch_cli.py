"""The port's CLI (``python -m dib_tpu_torch``) against the JAX package's.

The cases of ``tests/test_cli.py`` that the port covers run the port's
``train`` on the CPU (``device="cpu"``, a Python argument) at tiny widths:
encoders (8,), integration (16,), embedding 4, 2 + 4 epochs of 2 steps, the
MI hook at 64 rows x 1 batch (the CLI's 1024 x 8 forms [10, 1024, 1024, 4]
tensors on the CPU's plain path). Every flag of ``dib_tpu.cli.
build_parser()`` is in the port's parser with the same default, and the
port's refused flags are among them; ``sgd`` is ``optax.sgd`` over three
updates (1e-6). A resumed or preempted run must equal the uninterrupted one
bit for bit. ``test_torch_cli_models.py`` holds the models the flags build
against the JAX package's.
"""

import functools
import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dib_tpu.cli as jax_cli
from dib_tpu_torch import cli
import dib_tpu_torch.train
import dib_tpu_torch.train.hooks
from dib_tpu_torch.data import get_dataset
from dib_tpu_torch.data.registry import dataset_loss
from dib_tpu_torch.models import DistributedIBModel
from dib_tpu_torch.train import DIBTrainer, Every, InfoPerFeatureHook, TrainConfig, make_optimizer
from dib_tpu_torch.train.hooks import check_channel_width

torch.set_num_threads(1)

TOL = 1e-5
TINY = ["--number_pretraining_epochs", "2", "--number_annealing_epochs", "4",
        "--batch_size", "64", "--steps_per_epoch", "2", "--feature_encoder_architecture", "8",
        "--integration_network_architecture", "16", "--feature_embedding_dimension", "4",
        "--max_val_points", "64"]
CHECKPOINTS = ["--checkpoint_frequency", "2"]
ROADMAP_ITEM = "ROADMAP.md queue 1, item"


def _argv(outdir, *extra):
    return ["train", "--artifact_outdir", str(outdir), *TINY, *extra]


def _run(outdir, *extra):
    return cli.run(cli.build_parser().parse_args(_argv(outdir, *extra)), device="cpu")


@pytest.fixture(autouse=True)
def small_mi_hook(monkeypatch):
    """The CLI's MI hook at 64 rows x 1 batch."""
    monkeypatch.setattr(dib_tpu_torch.train, "InfoPerFeatureHook",
                        functools.partial(InfoPerFeatureHook, 64, 1))


# ------------------------------------------------------------------ flags

def test_parser_keeps_every_jax_flag_and_default():
    port = {a.dest: a for a in cli.build_parser()._actions}
    jax_actions = [a for a in jax_cli.build_parser()._actions if a.dest != "help"]
    for action in jax_actions:
        assert action.dest in port, action.dest
        assert port[action.dest].default == action.default, action.dest
        assert port[action.dest].option_strings == action.option_strings, action.dest
    assert set(cli.REFUSED_FLAGS) <= {a.dest for a in jax_actions}
    assert set(cli.REFUSED_SUBCOMMANDS) | {"train", "workload", "serve", "telemetry"} == set(
        next(a for a in jax_actions if a.dest == "command").choices)
    args = cli.build_parser().parse_args([])
    want = jax_cli.build_parser().parse_args([])
    assert vars(args) == vars(want)
    assert "events.jsonl" in cli.build_parser().format_help()


@pytest.mark.parametrize("argv,env", [
    (["--mesh_data", "2"], {}),
    (["--mesh_beta", "2"], {}),
    (["--engine", "shard_map"], {}),
    (["--infonce_loss", "--sweep_beta_ends", "0.1"], {}),
])
def test_unported_flags_are_refused_at_parse_time(monkeypatch, capsys, argv, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit) as excinfo:
        cli.build_parser().parse_args(["train", *argv])
    assert excinfo.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert "not ported" in err and ROADMAP_ITEM in err, err


@pytest.mark.parametrize("dataset", ["double_pendulum", "amorphous_radial_shells", "diabetes",
                                     "wine"])
def test_datasets_are_accepted_at_parse_time(capsys, dataset):
    """Every dataset of the JAX registry trains; the double pendulum's
    InfoNCE bundle needs --infonce_loss, as in the JAX package."""
    extra = ["--infonce_loss"] if dataset == "double_pendulum" else []
    args = cli.build_parser().parse_args(["train", "--dataset", dataset, *extra])
    assert args.dataset == dataset
    if extra:
        with pytest.raises(SystemExit) as excinfo:
            cli.build_parser().parse_args(["train", "--dataset", dataset])
        assert excinfo.value.code == 2
        assert "add --infonce_loss" in capsys.readouterr().err.strip().splitlines()[-1]


def test_every_jax_dataset_is_registered_and_unknown_names_are_refused(capsys):
    from dib_tpu.data import available_datasets

    assert get_dataset.__module__ == "dib_tpu_torch.data.registry"
    for name in available_datasets():
        extra = ["--infonce_loss"] if dataset_loss(name) == "infonce" else []
        cli.build_parser().parse_args(["train", "--dataset", name, *extra])
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["train", "--dataset", "no_such_dataset"])
    assert "Unknown dataset 'no_such_dataset'" in capsys.readouterr().err


@pytest.mark.parametrize("argv,env", [
    (["--watchdog"], {}),
    (["--heartbeat", "beat.json"], {}),
    (["--watchdog_floor_s", "10"], {}),
    (["--watchdog_first_timeout_s", "60"], {}),
    (["--telemetry-dir", "events"], {}),
    ([], {"DIB_FAULT_PLAN": "nan@chunk2"}),
])
def test_durability_flags_are_ported(monkeypatch, argv, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = cli.build_parser().parse_args(["train", *argv])
    assert cli.refusal(args, {a.dest: a.default for a in cli.build_parser()._actions}) is None


@pytest.mark.parametrize("argv", [
    ["lint"], ["ckpt", "scrub", "x"],
    ["telemetry", "tail", "x"], ["telemetry", "check", "x"],
    ["telemetry", "fleet", "summarize", "x"],
    ["workload", "chaos_state_sweep"], ["workload", "chaos"],
])
def test_unported_subcommands_are_refused(capsys, argv):
    try:
        code = cli.main(argv, device="cpu")
    except SystemExit as exc:          # a workload name, refused by its parser
        code = exc.code
    assert code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and ROADMAP_ITEM in err


@pytest.mark.parametrize("flag", ["--runs_root", "--runs-root", "DIB_RUNS_ROOT"])
def test_runs_root_registers_the_run(tmp_path, monkeypatch, capsys, flag):
    """``--runs-root`` (either spelling) or ``DIB_RUNS_ROOT`` registers the
    run at its end, and ``telemetry runs list`` lists it."""
    root = str(tmp_path / "runs")
    if flag == "DIB_RUNS_ROOT":
        monkeypatch.setenv(flag, root)
        extra = []
    else:
        monkeypatch.delenv("DIB_RUNS_ROOT", raising=False)
        extra = [flag, root]
    assert cli.main(_argv(tmp_path / "run", *extra), device="cpu") == 0
    [entry] = [json.loads(line) for line in open(os.path.join(root, "index.jsonl"))]
    assert entry["kind"] == "run" and entry["status"] == "ok"
    assert entry["run_dir"] == str(tmp_path / "run") and entry["metrics"]["total_steps"] == 12
    capsys.readouterr()
    assert cli.main(["telemetry", "runs", "list", "--runs-root", root]) == 0
    assert entry["run_id"] in capsys.readouterr().out


def test_telemetry_summarize_reads_a_train_run(tmp_path, capsys):
    """``telemetry summarize`` prints the record of the stream ``train``
    wrote; a directory with no stream exits 2."""
    _run(tmp_path / "run")
    capsys.readouterr()
    assert cli.main(["telemetry", "summarize", str(tmp_path / "run")]) == 0
    record = json.loads(capsys.readouterr().out)
    assert record["metric"] == "run_telemetry_summary" and record["status"] == "ok"
    assert record["total_steps"] == 12 and record["num_chunks"] >= 1
    os.makedirs(tmp_path / "empty")
    assert cli.main(["telemetry", "summarize", str(tmp_path / "empty")]) == 2


def test_serve_telemetry_dir_writes_the_stream_and_registers(tmp_path, monkeypatch, capsys):
    """``serve --telemetry-dir`` writes the serving run's stream there (run
    start with ``mode: "serve"``, the metrics rollup, run end), and
    ``--runs-root`` registers it."""
    monkeypatch.delenv("DIB_RUNS_ROOT", raising=False)
    ckpt = str(tmp_path / "ckpt")
    _run(tmp_path / "run", "--checkpoint_dir", ckpt, *CHECKPOINTS)
    events, root = tmp_path / "events", str(tmp_path / "runs")
    model_flags = ["--feature_encoder_architecture", "8", "--integration_network_architecture",
                   "16", "--feature_embedding_dimension", "4", "--batch_size", "64"]
    assert cli.main(["serve", "--checkpoint_dir", ckpt, *model_flags, "--port", "0",
                     "--outdir", str(tmp_path / "serve"), "--telemetry-dir", str(events),
                     "--runs-root", root, "--serve_seconds", "0.2"], device="cpu") == 0
    stream = [json.loads(line) for line in open(events / "events.jsonl")]
    assert [e["type"] for e in stream] == ["run_start", "metrics", "run_end"]
    manifest = stream[0]["manifest"]
    assert manifest["mode"] == "serve" and manifest["exec_cache"] == 0
    assert manifest["checkpoint_dir"] == os.path.abspath(ckpt)
    assert not os.path.exists(tmp_path / "serve" / "events.jsonl")
    [entry] = [json.loads(line) for line in open(os.path.join(root, "index.jsonl"))]
    assert entry["run_dir"] == str(events) and entry["status"] == "ok"


def test_accepted_values_of_refused_flags_train(tmp_path):
    args = cli.build_parser().parse_args(_argv(tmp_path, "--engine", "vmap",
                                               "--telemetry-dir", ""))
    assert args.engine == "vmap"


# -------------------------------------------------------------- train runs

def test_cli_train_produces_artifacts(tmp_path):
    summary = _run(tmp_path, "--info_bounds_frequency", "2")
    assert summary["dataset"] == "boolean_circuit" and "not_rendered" not in summary
    with np.load(tmp_path / "history.npz") as hist:
        assert hist["beta"].shape == (6,) and hist["kl_per_feature"].shape == (6, 10)
    with np.load(tmp_path / "info_bounds.npz") as bounds:
        assert bounds["epochs"].tolist() == [2, 4, 6]
        assert bounds["bounds_bits"].shape == (3, 10, 2)
    assert os.path.exists(tmp_path / "distributed_info_plane.png")
    with open(tmp_path / "run_summary.json") as f:
        assert json.load(f) == summary


def test_cli_without_matplotlib_writes_no_plot(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "matplotlib_available", lambda: False)
    summary = _run(tmp_path)
    plot = str(tmp_path / "distributed_info_plane.png")
    assert summary["not_rendered"] == [plot] and not os.path.exists(plot)
    assert os.path.exists(tmp_path / "history.npz")
    assert "matplotlib does not import" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="matplotlib"):
        _run(tmp_path, "--save_compression_matrices_frequency", "2")


def test_cli_vanilla_ib_single_bottleneck(tmp_path):
    _run(tmp_path, "--ib")
    with np.load(tmp_path / "history.npz") as hist:
        assert hist["kl_per_feature"].shape == (6, 1)


def test_cli_sweep_path(tmp_path):
    summary = _run(tmp_path, "--sweep_beta_ends", "0.1", "1.0", "--sweep_repeats", "2",
                   "--info_bounds_frequency", "2")
    assert summary["num_replicas"] == 4 and summary["beta_ends"] == [0.1, 0.1, 1.0, 1.0]
    assert len(summary["final_val_loss"]) == 4
    losses = []
    for r in range(4):
        with np.load(tmp_path / f"history_replica{r}.npz") as hist:
            assert hist["beta"].shape == (6,) and np.isfinite(hist["loss"]).all()
            losses.append(hist["loss"])
        with np.load(tmp_path / f"info_bounds_replica{r}.npz") as bounds:
            assert bounds["epochs"].tolist() == [2, 4, 6]
    assert not np.array_equal(losses[0], losses[1])      # repeats have their own seeds


def test_cli_infonce_path(tmp_path):
    summary = _run(tmp_path, "--infonce_loss", "--infonce_shared_dimensionality", "8",
                   "--infonce_y_encoder_architecture", "8")
    assert np.isfinite(summary["final_loss"])
    with np.load(tmp_path / "history.npz") as hist:
        assert np.isfinite(hist["val_loss"]).all()


def test_cli_checkpoint_resume_with_a_longer_budget(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _run(tmp_path, "--checkpoint_dir", ckpt, *CHECKPOINTS)
    assert "resumed_from_epoch" not in first and sorted(os.listdir(ckpt)) == ["2", "4", "6"]
    second = _run(tmp_path, "--checkpoint_dir", ckpt, *CHECKPOINTS,
                  "--number_annealing_epochs", "8")
    assert second["resumed_from_epoch"] == 6
    with np.load(tmp_path / "history.npz") as hist:
        assert hist["beta"].shape == (10,) and np.isfinite(hist["loss"]).all()
    assert sorted(os.listdir(ckpt)) == ["10", "6", "8"]


def test_save_info_bounds_merges_on_resume(tmp_path):
    path = str(tmp_path / "info_bounds.npz")
    cli._save_info_bounds(path, [2, 4], np.zeros((2, 3, 2)))
    cli._save_info_bounds(path, [6, 8], np.ones((2, 3, 2)), resumed_from=4)
    with np.load(path) as d:
        assert d["epochs"].tolist() == [2, 4, 6, 8] and int(d["resumed_from_epoch"]) == 4
        np.testing.assert_array_equal(d["bounds_bits"][:2], 0.0)
    cli._save_info_bounds(path, [4, 10], np.full((2, 3, 2), 2.0), resumed_from=2)
    with np.load(path) as d:
        assert d["epochs"].tolist() == [2, 4, 10]


@pytest.mark.parametrize("sweep", [False, True], ids=["serial", "sweep"])
def test_cli_resume_merges_info_bounds(tmp_path, sweep):
    extra = ["--sweep_beta_ends", "0.1", "1.0"] if sweep else []
    base = ["--checkpoint_dir", str(tmp_path / "ckpt"), *CHECKPOINTS,
            "--info_bounds_frequency", "2", *extra]
    _run(tmp_path, *base)
    summary = _run(tmp_path, *base, "--number_annealing_epochs", "8")
    assert summary["resumed_from_epoch"] == 6
    for name in (["info_bounds_replica0.npz", "info_bounds_replica1.npz"] if sweep
                 else ["info_bounds.npz"]):
        with np.load(tmp_path / name) as d:
            assert d["epochs"].tolist() == [2, 4, 6, 8, 10]
            assert int(d["resumed_from_epoch"]) == 6


class _SigtermOnce:
    """A stand-in MI hook that sends SIGTERM to its own process at its first
    call, as a preemption notice arriving mid-run."""

    fired = False

    def __init__(self, *args, **kwargs):
        self.records = []

    def __call__(self, trainer, state, epoch):
        if not _SigtermOnce.fired:
            _SigtermOnce.fired = True
            os.kill(os.getpid(), signal.SIGTERM)


@pytest.mark.parametrize("sweep", [False, True], ids=["serial", "sweep"])
def test_preemption_exits_75_and_resumes_bit_identically(tmp_path, monkeypatch, sweep):
    extra = ["--sweep_beta_ends", "0.1", "1.0"] if sweep else []
    argv = [*TINY, *CHECKPOINTS, "--info_bounds_frequency", "2", *extra]
    history = "history_replica1.npz" if sweep else "history.npz"
    assert cli.main(["--artifact_outdir", str(tmp_path / "whole"), "--checkpoint_dir",
                     str(tmp_path / "whole_ckpt"), *argv], device="cpu") == 0

    _SigtermOnce.fired = False
    monkeypatch.setattr(dib_tpu_torch.train, "InfoPerFeatureHook", _SigtermOnce)
    out, ckpt = tmp_path / "run", str(tmp_path / "ckpt")
    previous = signal.getsignal(signal.SIGTERM)
    assert cli.main(["--artifact_outdir", str(out), "--checkpoint_dir", ckpt, *argv],
                    device="cpu") == 75
    assert signal.getsignal(signal.SIGTERM) is previous         # the guard disarmed
    with open(out / "run_summary.json") as f:
        summary = json.load(f)
    assert summary["status"] == "preempted" and summary["preempted_at_epoch"] == 2
    assert sorted(os.listdir(ckpt)) == ["2"] and not os.path.exists(out / history)
    assert cli.main(["--artifact_outdir", str(out), "--checkpoint_dir", ckpt, *argv],
                    device="cpu") == 0
    with open(out / "run_summary.json") as f:
        assert json.load(f)["resumed_from_epoch"] == 2
    with np.load(out / history) as got, np.load(tmp_path / "whole" / history) as want:
        for name in want.files:
            np.testing.assert_array_equal(got[name], want[name], name)
    with np.load(os.path.join(ckpt, "6", "leaves.npz")) as got, \
            np.load(tmp_path / "whole_ckpt" / "6" / "leaves.npz") as want:
        assert got.files == want.files
        for name in want.files:
            np.testing.assert_array_equal(got[name], want[name], name)


def test_wide_channels_are_refused_before_training(tmp_path, monkeypatch):
    check_channel_width(64, "cuda")
    check_channel_width(65, "cpu")             # the plain path takes any width
    with pytest.raises(ValueError, match="at most 64"):
        check_channel_width(65, "cuda")
    bundle = get_dataset("boolean_circuit")
    model = DistributedIBModel(tuple(bundle.feature_dimensionalities), (8,), (16,), 1, 65,
                               device="cpu", generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = DIBTrainer(model, bundle, TrainConfig(batch_size=64, steps_per_epoch=2,
                                                    num_pretraining_epochs=2,
                                                    num_annealing_epochs=2), device="cpu")
    trainer.device = torch.device("cuda")      # as on the card: refused before any epoch
    with pytest.raises(ValueError, match="embedding dimension of at most 64"):
        trainer.fit(torch.Generator().manual_seed(0), hooks=[Every(2, InfoPerFeatureHook())],
                    hook_every=2)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    # the CLI, serial and sweep (through PerReplicaHook), with the check as on the card
    real = dib_tpu_torch.train.hooks.check_channel_width
    monkeypatch.setattr(dib_tpu_torch.train.hooks, "check_channel_width",
                        lambda d, device: real(d, "cuda"))
    for extra in ([], ["--sweep_beta_ends", "0.1", "1.0"]):
        with pytest.raises(ValueError, match="at most 64"):
            _run(tmp_path, "--feature_embedding_dimension", "65", "--info_bounds_frequency", "2",
                 *extra)
    assert not [name for name in os.listdir(tmp_path) if name.startswith("history")]


def test_cli_needs_the_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run(cli.build_parser().parse_args(_argv(tmp_path)))


def test_sgd_matches_optax_sgd():
    rng = np.random.default_rng(42)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    config = TrainConfig(learning_rate=0.1, optimizer="sgd", warmup_steps=2)
    weight = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer, schedule = make_optimizer(config, [weight])
    tx = optax.sgd(optax.linear_schedule(0.0, 0.1, 2))
    w, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(w)
    for g in grads:
        weight.grad = torch.from_numpy(g)
        optimizer.step()
        schedule.step()
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = optax.apply_updates(w, updates)
        np.testing.assert_allclose(weight.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# a tiny amorphous_protocols workload: config fields and driver keywords
PROTOCOL_SETS = [
    "protocols=('GradualQuench',)", "num_steps=2", "batch_size=4", "number_particles=8",
    "eval_every=2", "probe_every=2", "grid_side=4", "probe_data_batch=16",
    "mi_eval_batch_size=16", "mi_eval_batches=1", "warmup_steps=1",
    "num_synthetic_neighborhoods=64",
    "model_overrides={'encoder_hidden': (8,), 'embedding_dim': 4, 'num_blocks': 1, "
    "'num_heads': 2, 'key_dim': 8, 'ff_hidden': (8,), 'head_hidden': (8,)}"]


def _workload_argv(outdir):
    argv = ["workload", "amorphous_protocols", "--outdir", str(outdir)]
    for item in PROTOCOL_SETS:
        argv += ["--set", item]
    return argv


def test_workload_amorphous_protocols_runs_on_the_cpu(tmp_path, capsys):
    """``workload amorphous_protocols`` with ``--set`` overrides: config
    fields to the config, the rest to ``run_amorphous_protocols`` and the
    dataset."""
    assert cli.main(_workload_argv(tmp_path), device="cpu") == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(result) == ["GradualQuench"]
    assert result["GradualQuench"]["mi_epochs"] == "<array [1] int64>"
    assert result["GradualQuench"]["mi_bounds_bits"].startswith("<array [1, 8, 2]")
    with pytest.raises(SystemExit, match="Unknown AmorphousWorkloadConfig"):
        cli.main(["workload", "amorphous", "--set", "no_such_field=1"], device="cpu")


@pytest.mark.parametrize("name", ["chaos", "chaos_state_sweep"])
def test_chaos_workloads_are_refused_naming_item_5(capsys, name):
    with pytest.raises(SystemExit) as excinfo:
        cli.main(["workload", name], device="cpu")
    assert excinfo.value.code == 2
    assert f"{ROADMAP_ITEM} 5 (the chaos workloads)" in capsys.readouterr().err


def test_workload_boolean_runs_on_the_cpu(tmp_path, capsys):
    """``workload boolean`` at a tiny size prints the result's summary;
    ``--outdir`` is refused, as the JAX CLI refuses it (no artifact files)."""
    argv = ["workload", "boolean", "--set", "num_steps=4", "--set", "mi_every=2",
            "--set", "batch_size=32", "--set", "integration_hidden=(8,)"]
    assert cli.main(argv, device="cpu") == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["history"]["mi_lower_bits"] == "<array [2, 10] float32>"
    assert result["subset_informations"]["()"] == 0.0 and len(result["subset_informations"]) == 1024
    assert -1.0 <= result["rank_agreement_shapley"] <= 1.0
    with pytest.raises(SystemExit, match="does not write artifacts"):
        cli.main([*argv, "--outdir", str(tmp_path)], device="cpu")


def test_workload_characterization_prints_its_results(capsys):
    argv = ["workload", "characterization", "--set", "input_bits_list=(1,)",
            "--set", "scales=(1.0, 4.0)", "--set", "batch_sizes=(16,)", "--set", "num_repeats=2",
            "--set", "mc_samples=200"]
    assert cli.main(argv, device="cpu") == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["results"]
    assert [r["channel"]["scale"] for r in results] == [1.0, 4.0]
    assert all(r["batch_size"] == 16 and r["lower_mean"] <= r["upper_mean"] + 0.02
               for r in results)
    with pytest.raises(SystemExit, match="Unknown run_characterization argument"):
        cli.main(["workload", "characterization", "--set", "device='cuda'"], device="cpu")


def test_workload_registers_its_run(tmp_path, monkeypatch):
    """``workload --runs-root`` registers the workload's run (its stream in
    ``--outdir``) at its end."""
    monkeypatch.delenv("DIB_RUNS_ROOT", raising=False)
    root = str(tmp_path / "runs")
    assert cli.main([*_workload_argv(tmp_path / "run"), "--runs-root", root], device="cpu") == 0
    [entry] = [json.loads(line) for line in open(os.path.join(root, "index.jsonl"))]
    assert entry["run_dir"] == str(tmp_path / "run") and entry["status"] == "ok"
