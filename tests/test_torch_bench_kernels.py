"""The port's kernel microbench, run in-process on the CPU.

On the CPU the kernel arms take their plain versions, so this checks the
harness: the JAX script's record schema (``BENCH_KERNELS.json`` is its
committed record) less ``interpret`` and plus the card's ``name,
power.limit``, the arms and shapes, and parity against ``plain_full``.
"""

import json
import os

import numpy as np
import pytest
import torch

from dib_tpu_torch.scripts import bench_kernels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_record():
    with open(os.path.join(REPO, "BENCH_KERNELS.json")) as f:
        return json.loads(f.readline())


def test_microbench_record_on_cpu(tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert bench_kernels.main(["--device", "cpu", "--reps", "1", "--out", str(out)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    record = json.loads(printed[-1])
    assert json.loads(out.read_text()) == record
    jax_record = _jax_record()
    assert set(record) == (set(jax_record) - {"interpret"}) | {"card"}
    assert record["metric"] == jax_record["metric"] == "mi_kernel_bench"
    assert record["all_parity_ok"] is True
    assert record["device_kind"] == "cpu" and record["card"] is None
    assert "plain" in record["detail"]
    shapes = [(r["kind"], r["rows"], r["cols"], r["d"]) for r in record["rows"]]
    assert shapes == list(bench_kernels.CPU_SHAPES) == [
        (r["kind"], r["rows"], r["cols"], r["d"]) for r in jax_record["rows"]]
    for row, jax_row in zip(record["rows"], jax_record["rows"]):
        assert set(row) == {k.replace("xla_full", "plain_full") for k in jax_row}
        want = ({"plain_full", "plain_blocked", "cuda_mat", "fused"} if row["kind"] == "square"
                else {"plain_full", "cuda_mat", "fused"})
        assert set(row["variants"]) == set(row["parity"]["per_variant"]) == want
        assert all(v["seconds"] > 0 for v in row["variants"].values())
        assert row["parity"]["ok"] and row["parity"]["max_abs_err"] <= 2e-4


def test_microbench_fails_on_a_wrong_arm(monkeypatch, capsys):
    """A row whose arm disagrees with plain_full fails the run."""
    make_variants = bench_kernels.make_variants

    def broken(kind):
        variants = make_variants(kind)
        fused = variants["fused"]
        variants["fused"] = lambda *args: tuple(t + 1e-2 for t in fused(*args))
        return variants

    monkeypatch.setattr(bench_kernels, "make_variants", broken)
    monkeypatch.setattr(bench_kernels, "CPU_SHAPES", (("probe", 9, 7, 3),))
    assert bench_kernels.main(["--device", "cpu", "--reps", "1"]) == 1
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["all_parity_ok"] is False
    assert np.isclose(record["rows"][0]["parity"]["per_variant"]["fused"], 1e-2, rtol=1e-2)


def test_microbench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_kernels.main(["--reps", "1"])
