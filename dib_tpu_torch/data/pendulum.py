"""Double-pendulum simulation and dataset (counterpart of
``dib_tpu/data/pendulum.py``).

Every candidate trajectory integrates at once on the device with a
fixed-step float32 RK4, batched over trajectories (the JAX package's
``lax.scan`` becomes a Python loop over steps). The physics oracles are the
JAX package's:

  - energy-targeted initial conditions: theta1 uniform, theta2 solved for
    the prescribed potential energy at zero velocity (no solution: the
    candidate is invalid);
  - energy-drift rejection at a fractional tolerance of 1e-3;
  - a transient burn-in and temporal subsampling.

The dataset pairs each state, unrolled to (sin, -cos, omega) per arm, with
the state ``pendulum_time_delta`` seconds later; feature dims [2, 1, 2, 1],
InfoNCE loss.

A departure: the initial conditions come from a ``torch.Generator``, and
JAX's key stream cannot be reproduced, so a trajectory set simulated here
is not the JAX package's. The cache is how both packages share data:
:func:`fetch_double_pendulum` reads the JAX package's cache files first and
writes only under a name of its own (``double_pendulum_torch_n{N}_s{seed}.npy``),
so the JAX package never trains on this stream unawares.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from dib_tpu_torch.data.registry import DatasetBundle, register_dataset
from dib_tpu_torch.device import resolve_device

G = 9.81


def _deriv(state: torch.Tensor, m1, m2, l1, l2) -> torch.Tensor:
    """Equations of motion for states [..., 4] = (theta1, omega1, theta2, omega2)."""
    th1, w1, th2, w2 = state.unbind(-1)
    c, s = torch.cos(th1 - th2), torch.sin(th1 - th2)
    denom = m1 + m2 * s * s
    w1dot = (
        m2 * G * torch.sin(th2) * c
        - m2 * s * (l1 * w1 * w1 * c + l2 * w2 * w2)
        - (m1 + m2) * G * torch.sin(th1)
    ) / (l1 * denom)
    w2dot = (
        (m1 + m2) * (l1 * w1 * w1 * s - G * torch.sin(th2) + G * torch.sin(th1) * c)
        + m2 * l2 * w2 * w2 * s * c
    ) / (l2 * denom)
    return torch.stack([w1, w1dot, w2, w2dot], dim=-1)


def total_energy(state: torch.Tensor, m1=1.0, m2=1.0, l1=1.0, l2=1.0) -> torch.Tensor:
    """Total mechanical energy of states [..., 4] (the conservation oracle)."""
    th1, w1, th2, w2 = state.unbind(-1)
    v = -(m1 + m2) * l1 * G * torch.cos(th1) - m2 * l2 * G * torch.cos(th2)
    t = 0.5 * m1 * (l1 * w1) ** 2 + 0.5 * m2 * (
        (l1 * w1) ** 2 + (l2 * w2) ** 2 + 2 * l1 * l2 * w1 * w2 * torch.cos(th1 - th2)
    )
    return t + v


def _integrate(y0: torch.Tensor, dt: float, num_steps: int, save_every: int, keep_from: int = 0,
               drift: bool = False, m1=1.0, m2=1.0, l1=1.0, l2=1.0):
    """RK4-integrate a [B, 4] float32 batch for ``num_steps`` steps, saving
    every ``save_every``; returns the saved states from save ``keep_from`` on,
    [B, num_steps // save_every - keep_from, 4], and with ``drift`` each
    trajectory's largest fractional energy drift over EVERY save, [B] (else
    None). The step's constants round as the JAX package's float32 ``dt``
    makes them; each trajectory's numbers do not depend on the others."""
    dt32 = np.float32(dt)
    half, full, sixth = (float(np.float32(0.5) * dt32), float(dt32),
                         float(dt32 / np.float32(6.0)))
    y = y0.to(torch.float32)
    num_saves = num_steps // save_every
    saved = torch.empty((y.shape[0], max(num_saves - keep_from, 0), 4), dtype=torch.float32,
                        device=y.device)
    e0 = total_energy(y, m1, m2, l1, l2) if drift else None
    worst = torch.zeros_like(e0) if drift else None
    for i in range(num_saves):
        for _ in range(save_every):
            k1 = _deriv(y, m1, m2, l1, l2)
            k2 = _deriv(y + half * k1, m1, m2, l1, l2)
            k3 = _deriv(y + half * k2, m1, m2, l1, l2)
            k4 = _deriv(y + full * k3, m1, m2, l1, l2)
            y = y + sixth * (k1 + 2 * k2 + 2 * k3 + k4)
        if drift:
            worst = torch.maximum(worst, torch.abs(total_energy(y, m1, m2, l1, l2) - e0)
                                  / torch.abs(e0))
        if i >= keep_from:
            saved[:, i - keep_from] = y
    return saved, worst


def _integrate_batch(y0: torch.Tensor, dt: float, num_steps: int, save_every: int,
                     m1=1.0, m2=1.0, l1=1.0, l2=1.0) -> torch.Tensor:
    """RK4-integrate a [B, 4] batch of initial conditions for num_steps,
    saving every ``save_every`` steps: [B, num_steps // save_every, 4] (the
    JAX package's ``_integrate_batch``)."""
    return _integrate(y0, dt, num_steps, save_every, m1=m1, m2=m2, l1=l1, l2=l2)[0]


def _sample_initial_conditions(generator: torch.Generator, num: int, energy_over_g=4.0,
                               m1=1.0, m2=1.0, l1=1.0, l2=1.0):
    """Energy-targeted initial conditions, drawn from ``generator`` (on the
    device it draws on): [num, 4] float32 states and a validity mask (False
    where theta2 has no solution). The JAX package draws the same
    distribution from its key, a stream this cannot reproduce."""
    device = generator.device
    theta1 = torch.rand(num, generator=generator, device=device) * 2 * math.pi
    height1 = l1 * (1.0 - torch.cos(theta1))
    cos_arg = 1.0 - ((energy_over_g - m1 * height1) / m2 - height1) / l2
    sign = torch.randint(0, 2, (num,), generator=generator, device=device) * 2 - 1
    theta2 = torch.arccos(cos_arg) * sign
    valid = torch.abs(cos_arg) <= 1.0
    zeros = torch.zeros(num, device=device)
    return torch.stack([theta1, zeros, torch.nan_to_num(theta2), zeros], dim=-1), valid


# candidates are drawn in blocks of this many: the stream, and so the data,
# do not depend on how many candidates one pass integrates
DRAW_BLOCK = 1024
# blocks integrated together in one pass
BLOCKS_PER_PASS = 64


def simulate_double_pendulum(
    num_trajectories: int = 1000,
    initial_time: float = 50.0,
    simulation_time: float = 50.0,
    dt_simulation: float = 1e-2,
    dt_saving: float = 2e-2,
    energy_over_g: float = 4.0,
    fractional_energy_drift_tol: float = 1e-3,
    seed: int = 0,
    oversample: float = 1.5,
    device=None,
) -> np.ndarray:
    """Simulate [num_trajectories, T, 4] chaotic double-pendulum trajectories
    on ``device`` (``None`` means the GPU).

    The JAX package's rounds: each takes ``max(int(missing * oversample),
    16)`` candidates; a candidate whose energy drifts more than the
    tolerance over the run, or whose initial condition was infeasible, is
    rejected; rounds go on until enough survive. At dt = 1e-2 RK4's own
    error drifts the energy past 1e-3 for most candidates (in float64
    too), so a few percent survive and the rule takes on the order of a
    hundred rounds. A round on the GPU costs the same ~1.9 million launches
    (10,000 steps of ~185 operations) whatever its size, so the port
    integrates the candidate stream in passes of ``BLOCKS_PER_PASS``
    blocks of ``DRAW_BLOCK`` candidates and then walks the rounds over
    the integrated candidates in order: each round keeps what it would
    keep integrated on its own, and a pass is added when the rounds run
    past the integrated stream. Draws come from a generator seeded with
    ``seed`` on the device.
    """
    device = resolve_device(device)
    save_every = int(dt_saving // dt_simulation)
    num_steps = int((initial_time + simulation_time) / dt_simulation)
    burn_saved = int(initial_time / dt_simulation) // save_every

    generator = torch.Generator(device=device).manual_seed(seed)
    blocks_per_pass = BLOCKS_PER_PASS
    pass_size = blocks_per_pass * DRAW_BLOCK
    trajs, accepted = [], np.zeros(0, dtype=bool)     # per pass; every candidate's verdict

    def integrate_pass():
        nonlocal accepted
        draws = [_sample_initial_conditions(generator, DRAW_BLOCK, energy_over_g)
                 for _ in range(blocks_per_pass)]
        y0 = torch.cat([y for y, _ in draws])
        valid = torch.cat([v for _, v in draws])
        saved, drift = _integrate(y0, dt_simulation, num_steps, save_every,
                                  keep_from=burn_saved, drift=True)
        trajs.append(saved)
        verdict = (valid & (drift < fractional_energy_drift_tol)).cpu().numpy()
        accepted = np.concatenate([accepted, verdict])

    rows, position = [], 0
    while len(rows) < num_trajectories:
        batch = max(int((num_trajectories - len(rows)) * oversample), 16)
        while position + batch > len(accepted):
            integrate_pass()
        rows += (position + np.flatnonzero(accepted[position:position + batch])).tolist()
        position += batch
    kept = torch.stack([trajs[r // pass_size][r % pass_size] for r in rows[:num_trajectories]])
    return kept.cpu().numpy()


def unroll_angles(arr: np.ndarray) -> np.ndarray:
    """[..., T, 4] (th1, w1, th2, w2) -> [..., T, 6] (sin th1, -cos th1, w1,
    sin th2, -cos th2, w2)."""
    return np.stack(
        [
            np.sin(arr[..., 0]), -np.cos(arr[..., 0]), arr[..., 1],
            np.sin(arr[..., 2]), -np.cos(arr[..., 2]), arr[..., 3],
        ],
        axis=-1,
    )


def cache_paths(data_path: str, num_trajectories: int, seed: int) -> dict:
    """The trajectory caches under ``data_path``: the JAX package's keyed
    file, its legacy un-keyed file, and the port's own."""
    return {
        "jax": os.path.join(data_path, f"double_pendulum_n{num_trajectories}_s{seed}.npy"),
        "legacy": os.path.join(data_path, "double_pendulum.npy"),
        "torch": os.path.join(data_path,
                              f"double_pendulum_torch_n{num_trajectories}_s{seed}.npy"),
    }


def _cached(paths: dict, num_trajectories: int, seed: int) -> str | None:
    """The cache to read: the JAX package's keyed file, else its legacy
    file (trusted, as the JAX package trusts it, only for seed 0 and a
    matching trajectory count; the probe reads the header alone), else the
    port's own."""
    if os.path.exists(paths["jax"]):
        return paths["jax"]
    if (os.path.exists(paths["legacy"]) and seed == 0
            and np.load(paths["legacy"], mmap_mode="r").shape[0] == num_trajectories):
        return paths["legacy"]
    return paths["torch"] if os.path.exists(paths["torch"]) else None


@register_dataset("double_pendulum", loss="infonce")
def fetch_double_pendulum(
    data_path: str = "./data/",
    pendulum_time_delta: float = 2.0,
    num_trajectories: int = 1000,
    seed: int = 0,
    regenerate: bool = False,
    device=None,
    **_,
) -> DatasetBundle:
    """Predict the state ``pendulum_time_delta`` seconds ahead; features
    [2, 1, 2, 1] = (arm-1 direction, arm-1 omega, arm-2 direction, arm-2
    omega). Trajectories come from a cache (see the module docstring) or
    are simulated on ``device`` and cached under the port's own name;
    ``extras['cache']`` names the file."""
    os.makedirs(data_path, exist_ok=True)
    paths = cache_paths(data_path, num_trajectories, seed)
    cache = None if regenerate else _cached(paths, num_trajectories, seed)
    if cache is not None:
        data_arr = np.load(cache)
    else:
        data_arr = simulate_double_pendulum(num_trajectories=num_trajectories, seed=seed,
                                            device=device)
        cache = paths["torch"]
        np.save(cache, data_arr)

    dt_saving = 2e-2
    delta_steps = int(pendulum_time_delta / dt_saving)

    n_valid = int(data_arr.shape[0] * 0.1)
    valid_arr, train_arr = data_arr[:n_valid], data_arr[n_valid:]

    def pair(arr):
        x = arr[:, :-delta_steps].reshape(-1, 6)
        y = arr[:, delta_steps:].reshape(-1, 6)
        return x.astype(np.float32), y.astype(np.float32)

    x_train, y_train = pair(unroll_angles(train_arr))
    x_valid, y_valid = pair(unroll_angles(valid_arr))

    return DatasetBundle(
        x_train=x_train,
        y_train=y_train,
        x_valid=x_valid,
        y_valid=y_valid,
        feature_dimensionalities=[2, 1, 2, 1],
        output_dimensionality=6,
        loss="infonce",
        loss_is_info_based=True,
        feature_labels=["theta1", "theta1_dot", "theta2", "theta2_dot"],
        extras={"cache": cache},
    )
