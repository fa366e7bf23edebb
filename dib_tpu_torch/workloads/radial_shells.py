"""Amorphous-plasticity radial-density-shell workload (counterpart of
``dib_tpu/workloads/radial_shells.py``).

The standard Distributed IB path over per-shell density features: each
radial shell (x particle type) of a neighborhood is one scalar feature
with its own bottleneck (``amorphous_radial_shells``), trained by
``DistributedIBModel`` and ``DIBTrainer`` with the MI hook, and the beta
anneal maps which shells carry information about whether the central site
is a rearrangement locus. The headline readout is the information
allocated per shell against its radius.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from dib_tpu_torch.data.registry import get_dataset
from dib_tpu_torch.models.dib import DistributedIBModel
from dib_tpu_torch.ops.entropy import sequence_entropy_bits
from dib_tpu_torch.train.hooks import InfoPerFeatureHook
from dib_tpu_torch.train.loop import DIBTrainer, TrainConfig


@dataclass(frozen=True)
class RadialShellsConfig:
    """Tabular-path defaults (the CLI's scale, shorter pretraining)."""

    learning_rate: float = 3e-4
    batch_size: int = 128
    beta_start: float = 1e-4
    beta_end: float = 1.0
    num_pretraining_epochs: int = 200
    num_annealing_epochs: int = 2000
    num_shells: int = 10
    max_radius: float = 8.0
    encoder_hidden: tuple = (64, 64)
    integration_hidden: tuple = (128, 128)
    embedding_dim: int = 8
    eval_every: int = 200
    mi_eval_batch_size: int = 1024
    mi_eval_batches: int = 4


def run_radial_shells_workload(seed: int = 0, config: RadialShellsConfig | None = None,
                               outdir: str = "./radial_shells_out", *, device=None,
                               render: bool = True, **fetch_kwargs) -> dict:
    """Train the per-shell DIB on ``device`` (``None`` means the GPU) and
    produce the information-vs-radius profile.

    The weights come from a CPU generator seeded with ``seed``, the
    training draws from one on the device seeded with ``seed``; the MI hook
    draws from its own, seeded with 0. ``render=False`` draws nothing and
    writes nothing (for a machine without matplotlib). Returns the JAX
    driver's keys: ``state``, ``history`` (bits), ``bundle``,
    ``entropy_y_bits``, ``mi_bounds_bits`` [T, 2 * num_shells, 2],
    ``mi_epochs``, ``final_shell_profile_bits``,
    ``peak_shell_profile_bits``, ``info_plane_path`` and ``profile_path``
    (``None`` when ``render`` is off).
    """
    config = config or RadialShellsConfig()
    bundle = get_dataset("amorphous_radial_shells", num_shells=config.num_shells,
                         max_radius=config.max_radius, **fetch_kwargs)
    model = DistributedIBModel(
        feature_dimensionalities=tuple(bundle.feature_dimensionalities),
        encoder_hidden=config.encoder_hidden,
        integration_hidden=config.integration_hidden,
        output_dim=bundle.output_dimensionality,
        embedding_dim=config.embedding_dim,
        device=device, generator=torch.Generator().manual_seed(seed),
    )
    trainer = DIBTrainer(model, bundle, TrainConfig(
        learning_rate=config.learning_rate,
        batch_size=config.batch_size,
        beta_start=config.beta_start,
        beta_end=config.beta_end,
        num_pretraining_epochs=config.num_pretraining_epochs,
        num_annealing_epochs=config.num_annealing_epochs,
    ), device=device)
    # a bare hook (no Every): fit calls hooks after EVERY chunk, a short
    # final one included, so the last evaluation is never skipped
    info_hook = InfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches)
    state, records = trainer.fit(torch.Generator(device=trainer.device).manual_seed(seed),
                                 hooks=[info_hook], hook_every=config.eval_every)
    bits = records.to_bits()
    entropy_y = sequence_entropy_bits(np.asarray(bundle.y_train))

    plane_path = profile_path = None
    if render:
        from dib_tpu_torch.viz import save_distributed_info_plane

        os.makedirs(outdir, exist_ok=True)
        plane_path = save_distributed_info_plane(
            bits.kl_per_feature, bits.loss, outdir, entropy_y=entropy_y,
            info_plot_lims=(0.0, float(bits.total_kl.max()) + 1.0))
        profile_path = _save_shell_profile(bits, bundle.extras["shell_edges"],
                                           config.num_shells,
                                           os.path.join(outdir, "information_vs_radius.png"))
    bounds = info_hook.bounds_bits
    return {
        "state": state,
        "history": bits,
        "bundle": bundle,
        "entropy_y_bits": entropy_y,
        "mi_bounds_bits": bounds,                          # [T, 2 * num_shells, 2]
        "mi_epochs": info_hook.epochs,
        "final_shell_profile_bits": bounds[-1, :, 0] if info_hook.records else None,
        # the most each shell carried over the anneal (beta_end crushes
        # every channel by the final check, by design)
        "peak_shell_profile_bits": bounds[:, :, 0].max(axis=0) if info_hook.records else None,
        "info_plane_path": plane_path,
        "profile_path": profile_path,
    }


def _save_shell_profile(bits, shell_edges, num_shells, path) -> str | None:
    """The information ALLOCATED per shell (KL, bits) against radius as the
    budget tightens: one curve per remaining-budget fraction, at the anneal
    epochs where the total KL has shrunk to 50%, 25% and 10% of its peak
    (the final epoch when the anneal never got that far). The shells still
    holding information when the budget is scarce are where the
    task-relevant information lives."""
    from dib_tpu_torch.viz import pyplot

    plt = pyplot("_save_shell_profile")
    kl = bits.kl_per_feature                          # [T, 2 * num_shells]
    total = kl.sum(-1)
    peak = int(np.argmax(total))
    start = float(total[peak])
    if start <= 0:
        return None
    centers = 0.5 * (np.asarray(shell_edges)[:-1] + np.asarray(shell_edges)[1:])
    fig, axes = plt.subplots(1, 2, figsize=(9.6, 4), sharey=True)
    checkpoints = []
    for frac, alpha in ((0.5, 0.35), (0.25, 0.65), (0.1, 1.0)):
        # the first epoch AFTER the KL peak below the threshold (KL starts
        # near zero, so an unanchored search would land on epoch 0)
        below = np.nonzero(total[peak:] <= frac * start)[0]
        if len(below):
            checkpoints.append((f"{frac:.0%} budget left", peak + int(below[0]), alpha))
    if not checkpoints:
        checkpoints = [("final epoch", kl.shape[0] - 1, 1.0)]
    for label_text, epoch, alpha in checkpoints:
        for t, ax in enumerate(axes):
            sl = slice(t * num_shells, (t + 1) * num_shells)
            ax.plot(centers, kl[epoch, sl], marker="o", alpha=alpha,
                    color="C0" if t == 0 else "C1", label=label_text)
    for ax, type_label in zip(axes, "AB"):
        ax.set(xlabel="shell radius", title=f"type {type_label}")
        ax.legend(fontsize=8)
    axes[0].set_ylabel("information allocated (KL, bits)")
    fig.suptitle("Where the information lives, by radius")
    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path
