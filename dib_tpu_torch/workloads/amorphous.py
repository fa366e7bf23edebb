"""The amorphous-plasticity set-transformer workload, the flagship
(counterpart of ``dib_tpu/workloads/amorphous.py``).

Per-particle DIB (one shared Gaussian encoder, KL summed over latent dims
and particles) + set-transformer aggregator; 25k steps of batch 32
neighborhoods x 50 particles, a per-step beta log-ramp 2e-6 -> 2e-1, a
linear LR warmup, and:

  - per-particle MI sandwich bounds every ``eval_every`` steps
    (``InfoPerFeatureHook``);
  - probe-grid information maps every ``probe_every`` steps: a grid of
    phantom particles of each type scored against a bank of real data
    particles with the asymmetric M x N sandwich bounds
    (:func:`~dib_tpu_torch.ops.info_bounds.mi_sandwich_probe`, the probe
    mode of the ``mi_row_stats`` kernel on the GPU), masked where the
    pair-correlation density g(r) vanishes;
  - the distributed info plane: task loss against transmitted information.

:func:`run_amorphous_workload` is the single-schedule driver,
:func:`run_amorphous_protocols` its loop over quench protocols and
:func:`run_amorphous_sweep` the north-star run, the whole configuration
swept over a grid of beta endpoints as one stacked program, which
checkpoints and resumes with ``checkpoint_dir``. Not ported yet: the probe
grid sharded over a device mesh (``probe_mesh``) and the sweep's mesh.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from dib_tpu_torch.data.amorphous import per_particle_features
from dib_tpu_torch.data.registry import get_dataset
from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.models.mlp import Generators
from dib_tpu_torch.models.per_particle import PerParticleDIBModel
from dib_tpu_torch.ops.entropy import sequence_entropy_bits
from dib_tpu_torch.ops.gaussian import reparameterize
from dib_tpu_torch.ops.info_bounds import mi_sandwich_probe
from dib_tpu_torch.parallel.sweep import BetaSweepTrainer, member_seed
from dib_tpu_torch.train.hooks import Every, InfoPerFeatureHook
from dib_tpu_torch.train.loop import DIBTrainer, TrainConfig
from dib_tpu_torch.viz.info_plane import save_distributed_info_plane
from dib_tpu_torch.viz.probe_maps import density_mask, save_info_maps


@dataclass(frozen=True)
class AmorphousWorkloadConfig:
    """The flagship's defaults (the JAX package's ``AmorphousWorkloadConfig``)."""

    learning_rate: float = 1e-4
    batch_size: int = 32
    num_steps: int = 25_000
    beta_start: float = 2e-6
    beta_end: float = 2e-1
    warmup_steps: int = 500
    eval_every: int = 250             # MI bounds cadence, in steps
    probe_every: int = 1000           # info-map cadence (0 -> off)
    number_particles: int = 50
    grid_side: int = 100              # probe grid resolution
    grid_extent: float = 8.0          # probe positions span [-extent, extent]^2
    probe_data_batch: int = 512       # real-particle bank per bound evaluation
    mi_eval_batch_size: int = 1024
    mi_eval_batches: int = 4

    def train_config(self, steps_per_epoch: int = 1) -> TrainConfig:
        """As a TrainConfig with epoch == ``steps_per_epoch`` train steps
        (with 1, beta advances per step, the reference schedule)."""
        return TrainConfig(
            learning_rate=self.learning_rate,
            batch_size=self.batch_size,
            beta_start=self.beta_start,
            beta_end=self.beta_end,
            num_pretraining_epochs=0,
            num_annealing_epochs=self.num_steps // steps_per_epoch,
            steps_per_epoch=steps_per_epoch,
            warmup_steps=self.warmup_steps,
            max_val_points=1024,
        )


def build_model(config: AmorphousWorkloadConfig, *, device=None,
                generator: Generators = None, **overrides) -> PerParticleDIBModel:
    """The full architecture; ``overrides`` (e.g. ``use_flash``, or
    ``replicas`` for a sweep) set model fields, or shrink it for tests."""
    return PerParticleDIBModel(num_particles=config.number_particles, device=device,
                               generator=generator, **overrides)


# ---------------------------------------------------------------- probe grids

def probe_grid_positions(grid_side: int, extent: float) -> np.ndarray:
    """[G*G, 2] xy positions of the phantom-particle grid."""
    axis = np.linspace(-extent, extent, grid_side, dtype=np.float32)
    xx, yy = np.meshgrid(axis, axis)
    return np.stack([xx.ravel(), yy.ravel()], axis=-1)


def probe_features_for_type(positions: np.ndarray, type_id: int) -> np.ndarray:
    """[M, 12] engineered features of phantom particles of one type."""
    types = np.full(positions.shape[0], type_id, dtype=np.int32)
    return per_particle_features(positions, types, number_particles_to_use=-1)


def pair_correlation(sets: np.ndarray, num_bins: int = 64,
                     max_radius: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Radial pair-correlation histogram g(r) of real particles around the
    central site, from [N, P, 12] feature sets (radius is feature column 4).

    Normalized by the annulus area so empty excluded-volume bins read 0.
    Returns (g_r [num_bins], bin_edges [num_bins + 1]).
    """
    radii = np.asarray(sets)[..., 4].ravel()
    radii = radii[radii > 0]          # zero-padded slots sit at the origin
    if max_radius is None:
        max_radius = float(radii.max())
    hist, edges = np.histogram(radii, bins=num_bins, range=(0.0, max_radius))
    areas = np.pi * (edges[1:] ** 2 - edges[:-1] ** 2)
    g_r = hist / (areas * max(len(radii), 1))
    return g_r, edges


def probe_info_maps(model: PerParticleDIBModel, data_particles, config: AmorphousWorkloadConfig,
                    generator: torch.Generator | None = None, draws=None) -> list[np.ndarray]:
    """[G, G, 2] (lower, upper) info grids in nats, one per particle type.

    ``data_particles`` ([n, 12] real per-particle features, numpy or a
    tensor) is the pool the bank of ``config.probe_data_batch`` particles is
    drawn from. Each type's grid of phantom particles and the bank go
    through the shared particle encoder, and every probe is bounded against
    the bank by :func:`mi_sandwich_probe`: on the GPU one probe-mode
    ``mi_row_stats`` launch per type. Draws come from ``generator`` (on the
    model's device); ``draws`` = ``(bank_idx [bank], (eps_type1, eps_type2)
    [G*G, d] each)`` replaces them.
    """
    device = next(model.parameters()).device
    data = torch.as_tensor(data_particles, dtype=torch.float32, device=device)
    positions = probe_grid_positions(config.grid_side, config.grid_extent)
    if draws is None:
        idx = torch.randint(0, data.shape[0], (config.probe_data_batch,), generator=generator,
                            device=device)
        eps = (None, None)
    else:
        idx, eps = draws
        idx = torch.as_tensor(idx, device=device)
    grids = []
    with torch.inference_mode():
        data_mus, data_logvars = model.encode_feature(0, data[idx])
        for type_id, eps_t in zip((1, 2), eps):
            feats = torch.as_tensor(probe_features_for_type(positions, type_id), device=device)
            probe_mus, probe_logvars = model.encode_feature(0, feats)
            u = reparameterize(probe_mus, probe_logvars, generator,
                               None if eps_t is None else torch.as_tensor(eps_t, device=device))
            lower, upper = mi_sandwich_probe(probe_mus, probe_logvars, data_mus, data_logvars,
                                             u=u)
            grid = torch.stack([lower, upper], dim=-1).cpu().numpy()
            grids.append(grid.reshape(config.grid_side, config.grid_side, 2))
    return grids


class ProbeGridHook:
    """Records per-type probe-grid information maps at each invocation.

    The g(r) density mask is computed once from the training sets. Each call
    stores ``grids_by_step[epoch]`` and, with ``render`` (the default),
    writes ``info_map_step{epoch}.png`` into ``outdir``. Draws come from a
    generator seeded with ``seed`` on the model's device; ``draws`` (a
    callable ``(model, data_particles) -> (bank_idx, (eps_type1,
    eps_type2))``, called once per invocation) replaces them.
    """

    def __init__(self, outdir: str, model: PerParticleDIBModel, sets_train: np.ndarray,
                 config: AmorphousWorkloadConfig, seed: int = 0, draws=None,
                 render: bool = True):
        self.outdir = outdir
        self.model = model
        self.config = config
        self.seed = seed
        self.draws = draws
        self.render = render
        if render:
            os.makedirs(outdir, exist_ok=True)
        sets_train = np.asarray(sets_train)
        # flat bank of real per-particle features, uploaded once
        self.data_particles = torch.as_tensor(sets_train.reshape(-1, sets_train.shape[-1]),
                                              dtype=torch.float32,
                                              device=next(model.parameters()).device)
        g_r, edges = pair_correlation(sets_train)
        mask = density_mask(probe_grid_positions(config.grid_side, config.grid_extent),
                            g_r, edges[1:], config.grid_side)
        self.masks = [mask, mask]
        self.grids_by_step: dict[int, list[np.ndarray]] = {}
        self._generator = None

    def __call__(self, trainer, state, epoch: int):
        device = self.data_particles.device
        draws = None
        if self.draws is not None:
            draws = self.draws(self.model, self.data_particles)
        elif self._generator is None:
            self._generator = torch.Generator(device=device).manual_seed(self.seed)
        grids = probe_info_maps(self.model, self.data_particles, self.config,
                                generator=self._generator, draws=draws)
        self.grids_by_step[epoch] = grids
        if self.render:
            save_info_maps(grids, os.path.join(self.outdir, f"info_map_step{epoch}.png"),
                           masks=self.masks, titles=["type A", "type B"])


# ------------------------------------------------------------------- drivers

@dataclass(frozen=True)
class WorkloadDraws:
    """Replaces the random draws of :func:`run_amorphous_workload`, so that
    a test can replay another implementation's: ``params`` the initial
    weights (a state dict), ``train`` the trainer's draws object
    (``DIBTrainer.fit(draws=...)``), ``info`` and ``probe`` the hooks'
    ``draws`` callables. A field left ``None`` keeps the seeded draw."""

    params: dict | None = None
    train: object | None = None
    info: Callable | None = None
    probe: Callable | None = None


def run_amorphous_workload(seed: int = 0, config: AmorphousWorkloadConfig | None = None,
                           outdir: str = "./amorphous_out", steps_per_epoch: int = 1,
                           probe_maps: bool = True, model_overrides: dict | None = None, *,
                           device=None, render: bool = True, data_seed: int = 0,
                           draws: WorkloadDraws | None = None, **fetch_kwargs) -> dict:
    """Single-schedule end-to-end run (one protocol, one beta ramp).

    The model is initialised from ``seed`` and trained on ``device``
    (``None`` means the GPU) with draws from a generator seeded with
    ``seed``; the hooks draw from their own generators seeded with 0, as
    the JAX driver's hooks do. ``render=False`` plots nothing and writes
    nothing (for a machine without matplotlib); every grid, bound and
    history row is computed and returned all the same. ``data_seed`` and
    ``fetch_kwargs`` go to the ``amorphous_particles`` dataset (its
    ``seed`` and the rest: ``data_path``, ``protocol``, ...).

    Returns the JAX driver's keys: ``state`` (the port's ``TrainState``),
    ``history`` (bits), ``bundle``, ``entropy_y_bits``, ``mi_bounds_bits``
    [T, P, 2], ``mi_epochs``, ``probe_grids`` ({epoch: [grid per type]},
    nats) and ``info_plane_path`` (``None`` when ``render`` is off). The
    JAX driver's ``probe_mesh`` is not ported.
    """
    config = config or AmorphousWorkloadConfig()
    draws = draws or WorkloadDraws()
    bundle = get_dataset("amorphous_particles", number_particles_to_use=config.number_particles,
                         seed=data_seed, **fetch_kwargs)
    model = build_model(config, device=device, generator=torch.Generator().manual_seed(seed),
                        **(model_overrides or {}))
    if draws.params is not None:
        model.load_state_dict(draws.params)
    trainer = DIBTrainer(model, bundle, config.train_config(steps_per_epoch), device=device)

    info_hook = InfoPerFeatureHook(config.mi_eval_batch_size, config.mi_eval_batches,
                                   draws=draws.info)
    cadences = [max(config.eval_every // steps_per_epoch, 1)]
    hooks = [Every(cadences[0], info_hook)]
    probe_hook = None
    if probe_maps and config.probe_every:
        probe_hook = ProbeGridHook(outdir, model, bundle.extras["sets_train"], config,
                                   draws=draws.probe, render=render)
        cadences.append(max(config.probe_every // steps_per_epoch, 1))
        hooks.append(Every(cadences[-1], probe_hook))
    hook_every = math.gcd(*cadences)

    generator = None
    if draws.train is None:
        generator = torch.Generator(device=trainer.device).manual_seed(seed)
    state, history = trainer.fit(generator, hooks=hooks, hook_every=hook_every,
                                 draws=draws.train)
    bits = history.to_bits()
    entropy_y = sequence_entropy_bits(bundle.y_train.reshape(-1))
    plane_path = None
    if render:
        plane_path = save_distributed_info_plane(
            bits.kl_per_feature, bits.loss, outdir, entropy_y=entropy_y,
            info_plot_lims=(0.0, float(bits.total_kl.max()) + 1.0))
    return {
        "state": state,
        "history": bits,
        "bundle": bundle,
        "entropy_y_bits": entropy_y,
        "mi_bounds_bits": info_hook.bounds_bits,     # [T, P, 2]
        "mi_epochs": info_hook.epochs,
        "probe_grids": probe_hook.grids_by_step if probe_hook else {},
        "info_plane_path": plane_path,
    }


def run_amorphous_sweep(seed: int = 0, config: AmorphousWorkloadConfig | None = None,
                        beta_ends: Sequence[float] | None = None, num_repeats: int = 1,
                        outdir: str = "./amorphous_sweep_out", steps_per_epoch: int = 50,
                        model_overrides: dict | None = None, hooks: Sequence[Callable] = (),
                        chunk_epochs: int = 25, checkpoint_dir: str | None = None, *,
                        device=None, render: bool = True, data_seed: int = 0,
                        **fetch_kwargs) -> dict:
    """The north-star run: the full set-transformer configuration swept over
    a grid of beta endpoints (x seed repeats) as one stacked program on one
    device (``None`` means the GPU).

    ``beta_ends`` defaults to ``np.logspace(-2, 0, 8)``; each endpoint is
    repeated ``num_repeats`` times, and every member r has its own seed
    ``member_seed(seed, r)`` for its initial weights and its draws, so it
    replays a serial run of the same seed. ``hooks`` are sweep hooks
    (``SweepInfoPerFeatureHook``), called every ``chunk_epochs`` epochs.
    ``render=False`` plots nothing and writes nothing (for a machine without
    matplotlib). ``data_seed`` and ``fetch_kwargs`` go to the
    ``amorphous_particles`` dataset.

    ``checkpoint_dir``: a checkpoint of the stacked state and the members'
    generators is saved at every chunk boundary (after the other hooks),
    and when the directory already holds one the run resumes from it on the
    same chunk grid, bit for bit the run it continues. A
    ``SweepInfoPerFeatureHook`` resumes its records from its ``persist``
    directory (``resume=True``).

    Returns the JAX driver's keys that apply: ``states`` (stacked),
    ``records`` (one ``HistoryRecord`` per member, nats), ``beta_ends`` [R],
    ``wall_clock_s`` (``fit`` on the host clock, after a device
    synchronise), ``entropy_y_bits``, ``info_plane_paths`` (empty when
    ``render`` is off) and ``resumed_from_epoch`` (None for a fresh run).
    The JAX driver's ``mesh`` and ``use_mesh`` are not ported.
    """
    device = resolve_device(device)
    config = config or AmorphousWorkloadConfig()
    ends = np.repeat(np.asarray(np.logspace(-2, 0, 8) if beta_ends is None else beta_ends,
                                np.float64), num_repeats)
    seeds = [member_seed(seed, r) for r in range(len(ends))]
    bundle = get_dataset("amorphous_particles", number_particles_to_use=config.number_particles,
                         seed=data_seed, **fetch_kwargs)
    model = build_model(config, device=device, replicas=len(ends),
                        generator=[torch.Generator().manual_seed(s) for s in seeds],
                        **(model_overrides or {}))
    sweep = BetaSweepTrainer(model, bundle, config.train_config(steps_per_epoch),
                             config.beta_start, ends, device=device)
    generators = [torch.Generator(device=device).manual_seed(s) for s in seeds]
    hooks = list(hooks)
    states = histories = remaining = resumed_from = None
    if checkpoint_dir:
        from dib_tpu_torch.train.checkpoint import CheckpointHook, DIBCheckpointer

        ckpt = DIBCheckpointer(checkpoint_dir)
        # last: a checkpoint is written once the other hooks' records are
        hooks.append(CheckpointHook(ckpt))
        if ckpt.latest_step is not None:
            states, histories, generators = ckpt.restore(sweep, chunk_size=chunk_epochs)
            resumed_from = states.epoch
            remaining = max(sweep.config.num_epochs - resumed_from, 0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    states, records = sweep.fit(generators, remaining, hooks=hooks, hook_every=chunk_epochs,
                                states=states, histories=histories)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0

    entropy_y = sequence_entropy_bits(bundle.y_train.reshape(-1))
    paths = []
    if render:
        for r, record in enumerate(records):
            bits = record.to_bits()
            paths.append(save_distributed_info_plane(
                bits.kl_per_feature, bits.loss, outdir, entropy_y=entropy_y,
                info_plot_lims=(0.0, float(bits.total_kl.max()) + 1.0),
                filename=f"info_plane_replica{r}_betaend{ends[r]:.2e}.png"))
    return {
        "states": states,
        "records": records,
        "beta_ends": ends,
        "wall_clock_s": wall_s,
        "entropy_y_bits": entropy_y,
        "info_plane_paths": paths,
        "resumed_from_epoch": resumed_from,
    }


def run_amorphous_protocols(seed: int = 0,
                            protocols: Sequence[str] = ("GradualQuench", "RapidQuench"),
                            config: AmorphousWorkloadConfig | None = None,
                            outdir: str = "./amorphous_out", **workload_kwargs) -> dict:
    """One full per-particle run per quench protocol (the reference's outer
    loop), each with its own artifact subdirectory and seed.

    Real ``{protocol}.npz`` exports are used when present under
    ``data_path``; otherwise each protocol gets an independent synthetic
    surrogate (a distinct fetch seed). Returns ``{protocol: result}`` with
    the contract of :func:`run_amorphous_workload`.
    """
    if isinstance(protocols, str):
        # a bare name would iterate character by character, one run per letter
        protocols = (protocols,)
    results = {}
    for i, protocol in enumerate(protocols):
        kwargs = dict(workload_kwargs)
        kwargs["data_seed"] = kwargs.get("data_seed", 0) + 7919 * i   # independent surrogates
        run_seed = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
        results[protocol] = run_amorphous_workload(
            run_seed, config=config, outdir=os.path.join(outdir, protocol),
            protocol=protocol, **kwargs)
    return results
