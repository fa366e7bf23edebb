"""Boolean-circuit information decomposition (counterpart of
``dib_tpu/workloads/boolean.py``).

  - :class:`BooleanDIBModel`: a two-parameter binary encoder per input
    (:class:`~dib_tpu_torch.models.encoders.SimpleBinaryEncoderBank`, mean
    scale 1 and log-variance -3 at the start) and an integration MLP.
  - :class:`BooleanTrainer`: a per-STEP log-beta ramp (1e-3 -> 5 over 5e4
    steps, batch 512) with Adam, trained in chunks of ``mi_cadence`` steps;
    after each chunk the sandwich bounds of every channel on the full
    1024-row truth table are measured in ONE ``mi_row_stats`` launch over
    [F, N, d], overlapped with the next chunk on a side CUDA stream
    (``train/overlap.py``), as the JAX loop overlaps it.
  - the exact oracles: the MI of every input subset, the best subset of
    each size, Shapley values of I(X_S; Y), logistic-regression
    importances and the Spearman agreement of the DIB allocation with them.

Draws: the weights from a CPU generator, batch rows and noise from a
generator on the device, the MI measurement's noise from a generator of
its own. A test replays JAX's draws through ``train_step`` and
``channel_mi_bounds(u=)``.

A departure: the JAX package fits scikit-learn's ``LogisticRegression``,
which the card's machine does not have. :func:`logistic_regression_importances`
solves the same problem (L2, C = 1, an unpenalised intercept) by Newton's
method in float64 to convergence, where scikit-learn's L-BFGS stops at its
tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from math import factorial
from typing import Sequence

import numpy as np
import torch
from torch import nn

from dib_tpu_torch.data.boolean_circuit import (
    exact_subset_informations,
    fetch_boolean_circuit,
    num_circuit_inputs,
)
from dib_tpu_torch.device import resolve_device
from dib_tpu_torch.models.encoders import SimpleBinaryEncoderBank
from dib_tpu_torch.models.mlp import MLP
from dib_tpu_torch.ops.entropy import LN2, sequence_entropy_bits
from dib_tpu_torch.ops.gaussian import kl_diagonal_gaussian, reparameterize
from dib_tpu_torch.ops.info_bounds import mi_sandwich_from_params
from dib_tpu_torch.ops.schedules import log_annealed_beta
from dib_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS
from dib_tpu_torch.train.losses import bce_with_logits, binary_accuracy


class BooleanDIBModel(nn.Module):
    """Simple binary encoders (2 parameters each) -> samples -> integration
    MLP. ``forward`` returns ``(logits, aux)`` with aux carrying the
    per-channel batch-mean KL [F] and the channel parameters [F, B, d], as
    :class:`~dib_tpu_torch.models.dib.DistributedIBModel` does. The MLP's
    weights come from ``generator`` on the CPU; the model then moves to
    ``device`` (``None`` means the GPU)."""

    def __init__(self, num_features: int, integration_hidden: Sequence[int] = (256, 256),
                 embedding_dim: int = 1, logvar_init: float = -3.0, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_features = num_features
        self.embedding_dim = embedding_dim
        self.encoders = SimpleBinaryEncoderBank(num_features, embedding_dim, logvar_init)
        self.integration = MLP(num_features * embedding_dim, tuple(integration_hidden), 1,
                               "relu", generator=generator)
        self.to(resolve_device(device))

    def noise_shape(self, batch: int) -> tuple:
        return (self.num_features, batch, self.embedding_dim)

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None, sample: bool = True,
                generator: torch.Generator | None = None):
        mus, logvars = self.encoders(x)                                      # [F, B, d]
        u = reparameterize(mus, logvars, generator, eps=eps) if sample else mus
        kl_per_feature = kl_diagonal_gaussian(mus, logvars, dim=-1).mean(-1)
        embeddings = u.movedim(0, 1).reshape(x.shape[0], -1)
        logits = self.integration(embeddings)
        aux = {"kl_per_feature": kl_per_feature, "mus": mus, "logvars": logvars,
               "embeddings": embeddings}
        return logits, aux


@dataclass(frozen=True)
class BooleanWorkloadConfig:
    """Defaults of the notebook's training cell (5e4 steps, batch 512, beta
    1e-3 -> 5, bounds every ``num_steps // 200`` steps)."""

    learning_rate: float = 1e-3
    batch_size: int = 512
    num_steps: int = 50_000
    beta_start: float = 1e-3
    beta_end: float = 5.0
    mi_every: int = 0                 # 0 -> num_steps // 200
    integration_hidden: tuple = (256, 256)
    embedding_dim: int = 1
    logvar_init: float = -3.0

    @property
    def mi_cadence(self) -> int:
        return self.mi_every or max(1, self.num_steps // 200)


@dataclass
class BooleanTrainState:
    """The trained model (updated in place), Adam, and the steps done."""

    model: BooleanDIBModel
    optimizer: torch.optim.Optimizer
    step: int


class BooleanDraws:
    """A step's batch rows and encoder noise from one generator on the
    device; a test replays another implementation's draws with an object
    of the same ``step`` method."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def step(self, n: int, batch_size: int, noise_shape) -> tuple[torch.Tensor, torch.Tensor]:
        device = self.generator.device
        idx = torch.randint(0, n, (batch_size,), generator=self.generator, device=device)
        return idx, torch.randn(noise_shape, generator=self.generator, device=device)


class BooleanTrainer:
    """Per-step beta-annealed trainer with per-channel MI measurement, on
    ``device`` (``None`` means the GPU)."""

    def __init__(self, bundle, config: BooleanWorkloadConfig, *, device=None):
        self.bundle = bundle
        self.config = config
        self.device = resolve_device(device)
        self._x = torch.as_tensor(bundle.x_train, dtype=torch.float32, device=self.device)
        self._y = torch.as_tensor(bundle.y_train, dtype=torch.float32, device=self.device)

    def init(self, generator: torch.Generator | None = None) -> BooleanTrainState:
        """A fresh model, its weights from the CPU ``generator``, and Adam."""
        cfg = self.config
        model = BooleanDIBModel(self.bundle.number_features, cfg.integration_hidden,
                                cfg.embedding_dim, cfg.logvar_init, device=self.device,
                                generator=generator)
        optimizer = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                                     betas=ADAM_BETAS, eps=ADAM_EPS)
        return BooleanTrainState(model, optimizer, 0)

    def loss(self, model, x, y, beta: float, eps):
        """(loss, aux): BCE + beta * the summed channel KL."""
        logits, aux = model(x, eps=eps)
        task = bce_with_logits(logits, y)
        return task + beta * aux["kl_per_feature"].sum(), {
            "task": task, "kl": aux["kl_per_feature"], "logits": logits}

    def train_step(self, state: BooleanTrainState, idx, eps, beta: float) -> dict:
        """One Adam update on rows ``idx`` of the table with noise ``eps``."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss(state.model, self._x[idx], self._y[idx], beta, eps)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"task": aux["task"].detach(), "kl": aux["kl"].detach()}

    def run_chunk(self, state: BooleanTrainState, draws, num_steps: int) -> dict:
        """``num_steps`` steps; returns the per-step series on the device:
        task [S], kl [S, F] and beta [S]."""
        cfg = self.config
        betas = log_annealed_beta(torch.arange(state.step, state.step + num_steps),
                                  cfg.beta_start, cfg.beta_end, cfg.num_steps, 0)
        n = self._x.shape[0]
        tasks, kls = [], []
        for beta in betas.tolist():
            idx, eps = draws.step(n, cfg.batch_size, state.model.noise_shape(cfg.batch_size))
            stats = self.train_step(state, idx, eps, beta)
            tasks.append(stats["task"])
            kls.append(stats["kl"])
        return {"task": torch.stack(tasks), "kl": torch.stack(kls), "beta": betas}

    def channel_mi(self, model, generator: torch.Generator | None = None,
                   u: torch.Tensor | None = None):
        """([F] lower, [F] upper) sandwich bounds in nats of every channel on
        the full truth table, all F channels in one ``mi_row_stats`` launch;
        ``u`` ([F, N, d]) replaces the draw from ``generator``."""
        with torch.inference_mode():
            mus, logvars = model.encoders(self._x)                           # [F, N, d]
            if u is None:
                u = reparameterize(mus, logvars, generator)
            return mi_sandwich_from_params(mus, logvars, u=u.to(self.device))

    def channel_mi_bounds(self, state: BooleanTrainState,
                          generator: torch.Generator | None = None,
                          u: torch.Tensor | None = None):
        """:meth:`channel_mi` of the state's model."""
        return self.channel_mi(state.model, generator, u)

    def full_table_eval(self, state: BooleanTrainState, generator: torch.Generator | None = None):
        """(bce, accuracy) over the whole truth table, with sampled noise."""
        with torch.inference_mode():
            logits, _ = state.model(self._x, generator=generator)
            return bce_with_logits(logits, self._y), binary_accuracy(logits, self._y)

    def fit(self, generator: torch.Generator,
            state: BooleanTrainState | None = None, telemetry=None, *,
            init_generator: torch.Generator | None = None,
            mi_generator: torch.Generator | None = None):
        """Train ``config.num_steps`` steps with an MI check every
        ``mi_cadence``. Returns (state, history): per-step ``task``, ``kl``
        and ``beta``, and at each check ``mi_steps``, ``mi_betas`` and the
        per-channel bounds in BITS, ``mi_lower_bits`` and ``mi_upper_bits``
        [C, F].

        Training draws come from ``generator`` (on the device); a fresh
        state's weights from ``init_generator`` (CPU, seed 0 if None); the
        checks' noise from ``mi_generator`` (on the device, seed 0 if None).
        Each check measures a snapshot of the weights on a side stream while
        the next chunk trains and is filed at the next boundary: its numbers
        are those of ``channel_mi_bounds`` on the weights at its step.
        ``telemetry`` (an ``EventWriter``) gets one ``chunk`` event per
        chunk, one ``mi_bounds`` event per check, spans and heartbeats.
        """
        from dib_tpu_torch.telemetry import trace
        from dib_tpu_torch.telemetry.hooks import FitRecorder
        from dib_tpu_torch.train.overlap import OverlapRunner

        cfg = self.config
        draws = BooleanDraws(generator)
        if state is None:
            state = self.init(init_generator or torch.Generator().manual_seed(0))
        if mi_generator is None:
            mi_generator = torch.Generator(device=self.device).manual_seed(0)
        # chunks are counted in steps: one step per "epoch"
        recorder = FitRecorder(telemetry, steps_per_epoch=1)
        runner = OverlapRunner()
        series = {"task": [], "kl": [], "beta": []}
        checks = {"step": [], "beta": [], "lower_bits": [], "upper_bits": []}
        pending = None
        with trace.use_tracer(recorder.tracer), recorder.heartbeats():
            while state.step < cfg.num_steps:
                chunk = min(cfg.mi_cadence, cfg.num_steps - state.step)
                with recorder.chunk_phase() as phase:
                    stats = self.run_chunk(state, draws, chunk)
                    phase.block_on(stats["task"])
                # the previous boundary's check ran under this chunk
                if pending is not None:
                    self._collect_mi(pending, telemetry, checks)
                shadow = runner.snapshot(state.model)
                pending = runner.launch(lambda: self.channel_mi(shadow, mi_generator),
                                        self.device, epoch=state.step, reads=[self._x])
                stats_h = {name: value.cpu().numpy() for name, value in stats.items()}
                for name in series:
                    series[name].append(stats_h[name])
                recorder.record_chunk(epoch=state.step, chunk_epochs=chunk,
                                      beta=float(stats_h["beta"][-1]),
                                      loss=float(stats_h["task"][-1]),
                                      kl_per_feature=[float(x) for x in stats_h["kl"][-1]])
                checks["beta"].append(float(stats_h["beta"][-1]))
            if pending is not None:
                self._collect_mi(pending, telemetry, checks)
        recorder.finish()
        history = {name: np.concatenate(vals) for name, vals in series.items()}
        history["mi_steps"] = np.asarray(checks["step"])
        history["mi_betas"] = np.asarray(checks["beta"])
        history["mi_lower_bits"] = np.stack(checks["lower_bits"])      # [C, F]
        history["mi_upper_bits"] = np.stack(checks["upper_bits"])
        return state, history

    @staticmethod
    def _collect_mi(pending, telemetry, checks) -> None:
        """File one check: wait for it (a span of the exposed wait), record
        its row and write the ``mi_bounds`` event at the step it measured."""
        from dib_tpu_torch.train.overlap import collect_overlapped

        lower, upper = collect_overlapped(pending)
        checks["step"].append(pending.meta["epoch"])
        checks["lower_bits"].append(lower.numpy() / LN2)
        checks["upper_bits"].append(upper.numpy() / LN2)
        if telemetry is not None:
            telemetry.mi_bounds(epoch=pending.meta["epoch"],
                                lower_bits=[float(x) for x in checks["lower_bits"][-1]],
                                upper_bits=[float(x) for x in checks["upper_bits"][-1]])


# --------------------------------------------------------------------------
# the exact ground-truth analyses (host-side numpy)

def best_subsets_by_size(subset_informations: dict) -> dict:
    """{k: (subset, MI bits)}: the max-MI input subset of each cardinality."""
    out = {}
    for subset, info in subset_informations.items():
        k = len(subset)
        if k == 0:
            continue
        if k not in out or info > out[k][1]:
            out[k] = (subset, info)
    return out


def shapley_values_bits(truth_table: np.ndarray, num_inputs: int,
                        subset_informations: dict | None = None) -> np.ndarray:
    """Exact Shapley value of each input with value function v(S) = I(X_S; Y)
    in bits (SAGE's importance with cross-entropy loss and a Bayes-optimal
    model, exact on a full truth table):

        phi_i = sum_{S subseteq N minus i} |S|! (n-|S|-1)! / n! [v(S+i) - v(S)]

    Exhaustive over all 2^n subsets."""
    if subset_informations is None:
        subset_informations = exact_subset_informations(truth_table, num_inputs)
    n = num_inputs
    phis = np.zeros(n)
    for i in range(n):
        rest = [j for j in range(n) if j != i]
        for k in range(n):
            weight = factorial(k) * factorial(n - k - 1) / factorial(n)
            for subset in combinations(rest, k):
                with_i = tuple(sorted(subset + (i,)))
                phis[i] += weight * (subset_informations[with_i] - subset_informations[subset])
    return phis


def logistic_regression_importances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """|coefficient| of an L2 logistic regression on the +-1 inputs (the
    linear baseline beside the Shapley values): it minimises
    ``sum_i logloss_i + |w|^2 / 2`` with an unpenalised intercept, the
    objective of scikit-learn's ``LogisticRegression()`` (C = 1), by
    Newton's method in float64 until the step is below 1e-10 (at most 100
    steps)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    design = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
    penalty = np.ones(design.shape[1])
    penalty[-1] = 0.0                                    # the intercept
    w = np.zeros(design.shape[1])
    for _ in range(100):
        p = 1.0 / (1.0 + np.exp(-(design @ w)))
        grad = design.T @ (p - y) + penalty * w
        hess = (design * (p * (1.0 - p))[:, None]).T @ design + np.diag(penalty)
        delta = np.linalg.solve(hess, grad)
        w -= delta
        if np.max(np.abs(delta)) < 1e-10:
            break
    return np.abs(w[:-1])


def allocation_rank_agreement(dib_bits: np.ndarray, oracle_bits: np.ndarray) -> float:
    """Spearman rank correlation of the DIB's per-channel allocation with an
    oracle importance vector (0 where either is constant)."""
    from scipy.stats import spearmanr

    dib = np.asarray(dib_bits)
    oracle = np.asarray(oracle_bits)
    if np.ptp(dib) == 0 or np.ptp(oracle) == 0:
        return 0.0
    rho = spearmanr(dib, oracle).statistic
    return float(rho) if np.isfinite(rho) else 0.0


def run_boolean_workload(seed: int = 0, config: BooleanWorkloadConfig | None = None,
                         circuit_specification=None, telemetry=None, *, device=None,
                         **fetch_kwargs) -> dict:
    """The boolean-circuit decomposition end to end, with every exact oracle,
    on ``device`` (``None`` means the GPU). The weights come from a CPU
    generator seeded with ``seed``, the training draws from one on the
    device seeded with ``seed``, the MI checks' noise from one seeded with
    ``seed + 1`` and the final evaluation's from one seeded with ``seed + 2``.

    Returns the JAX driver's keys: the trained ``state``, ``history`` (with
    the per-channel MI trajectories in bits), ``bundle``, ``entropy_y_bits``,
    ``final_bce``, ``final_accuracy``, ``subset_informations``,
    ``best_subsets``, ``shapley_bits``, ``logreg_importances``,
    ``final_allocation_bits``, ``allocation_persistence_bits`` and the rank
    agreements with Shapley values and with the regression.
    """
    config = config or BooleanWorkloadConfig()
    bundle = fetch_boolean_circuit(circuit_specification=circuit_specification, **fetch_kwargs)
    table = bundle.extras["truth_table"]
    n = num_circuit_inputs(bundle.extras["circuit_specification"])

    trainer = BooleanTrainer(bundle, config, device=device)
    device = trainer.device

    def on_device(offset):
        return torch.Generator(device=device).manual_seed(seed + offset)

    state, history = trainer.fit(on_device(0), telemetry=telemetry,
                                 init_generator=torch.Generator().manual_seed(seed),
                                 mi_generator=on_device(1))
    bce, acc = trainer.full_table_eval(state, on_device(2))

    subset_infos = exact_subset_informations(table, n)
    shapley = shapley_values_bits(table, n, subset_infos)
    logreg = logistic_regression_importances(bundle.x_train, bundle.y_train)
    final_alloc = history["mi_lower_bits"][-1]
    # the allocation's PERSISTENCE, not its endpoint (a full anneal crushes
    # every channel): the mean of each channel's lower bound over the
    # log-beta ramp, in bits; the endpoint for a run of one check
    lower = np.clip(history["mi_lower_bits"], 0.0, None)       # [C, F]
    log_betas = np.log(np.asarray(history["mi_betas"]))
    span = float(log_betas[-1] - log_betas[0])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz     # numpy < 2
    if lower.shape[0] > 1 and span > 0:
        alloc = trapezoid(lower, x=log_betas, axis=0) / span
    else:
        alloc = final_alloc

    return {
        "state": state,
        "history": history,
        "bundle": bundle,
        "entropy_y_bits": sequence_entropy_bits(table[:, -1]),
        "final_bce": float(bce),
        "final_accuracy": float(acc),
        "subset_informations": subset_infos,
        "best_subsets": best_subsets_by_size(subset_infos),
        "shapley_bits": shapley,
        "logreg_importances": logreg,
        "final_allocation_bits": final_alloc,
        "allocation_persistence_bits": alloc,
        "rank_agreement_shapley": allocation_rank_agreement(alloc, shapley),
        "rank_agreement_logreg": allocation_rank_agreement(alloc, logreg),
    }
