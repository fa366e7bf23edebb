"""Amorphous-plasticity (glass) data: per-particle feature sets and radial
density shells (counterpart of ``dib_tpu/data/amorphous.py``).

Pure numpy, so the same seed gives the same arrays as the JAX package:

  - ``per_particle_features``: positions, squared positions, radius, log
    radius, log squared positions, unit vectors and a two-way type one-hot
    (12 dims) per particle, radius-sorted and clipped to the nearest
    ``number_particles_to_use``;
  - ``synthetic_glass_neighborhoods``: surrogate binary-mixture
    neighborhoods with a planted local-structure -> rearrangement signal,
    used when no real ``{protocol}.npz`` export is present;
  - ``load_glass_splits`` / ``load_glass_protocol``: the real exports;
  - ``fetch_amorphous_radial_shells``: per-shell, per-type particle
    densities, one scalar channel each.
"""

from __future__ import annotations

import os

import numpy as np

from dib_tpu_torch.data.registry import DatasetBundle, register_dataset

SAFETY_EPS = 1e-12
PARTICLE_FEATURE_DIM = 12


def per_particle_features(positions: np.ndarray, types: np.ndarray,
                          number_particles_to_use: int = 50) -> np.ndarray:
    """[P, 2] positions + [P] types (1/2) -> [number_particles_to_use, 12].

    Feature layout: x, y, x^2, y^2, r, log r, log x^2, log y^2, x/r, y/r,
    onehot_A, onehot_B. Short neighborhoods are zero-padded; pass -1 to keep
    every particle (probe grids).
    """
    positions = np.asarray(positions, dtype=np.float32)
    types = np.asarray(types).astype(np.int32).reshape(-1)
    radii = np.sqrt(np.sum(positions**2, -1, keepdims=True) + SAFETY_EPS)
    unit = positions / radii
    onehot = np.eye(2, dtype=np.float32)[np.clip(types - 1, 0, 1)]
    feats = np.concatenate(
        [positions, positions**2, radii, np.log(radii + 1e-3),
         np.log(positions**2 + 1e-3), unit, onehot],
        axis=-1,
    ).astype(np.float32)
    if number_particles_to_use > 0:
        order = np.argsort(radii[:, 0])
        feats = feats[order][:number_particles_to_use]
        if feats.shape[0] < number_particles_to_use:
            pad = number_particles_to_use - feats.shape[0]
            feats = np.concatenate([feats, np.zeros((pad, feats.shape[1]), np.float32)])
    return feats


def synthetic_glass_neighborhoods(num_neighborhoods: int = 2048,
                                  particles_per_neighborhood: int = 60, seed: int = 0,
                                  box_radius: float = 8.0, core_radius: float = 1.0):
    """Surrogate binary-mixture neighborhoods with a planted signal.

    Particles are uniform in an annulus around the central site; the label
    depends on the type composition and crowding of the nearest shell.
    Returns (positions list [P, 2], types list [P], labels [N, 1]).
    """
    rng = np.random.default_rng(seed)
    positions, types, labels = [], [], []
    for _ in range(num_neighborhoods):
        p = particles_per_neighborhood + int(rng.integers(-5, 6))
        r = np.sqrt(rng.uniform(core_radius**2, box_radius**2, size=p))
        theta = rng.uniform(0, 2 * np.pi, size=p)
        pos = np.stack([r * np.cos(theta), r * np.sin(theta)], -1)
        typ = rng.integers(1, 3, size=p)
        near = r < 2.5
        frac_b_near = np.mean(typ[near] == 2) if near.any() else 0.5
        crowding = near.sum() / p
        logit = 6.0 * (frac_b_near - 0.5) + 8.0 * (crowding - 0.15)
        label = float(rng.random() < 1.0 / (1.0 + np.exp(-logit)))
        positions.append(pos.astype(np.float32))
        types.append(typ.astype(np.float32))
        labels.append(label)
    return positions, types, np.asarray(labels, dtype=np.float32)[:, None]


def build_neighborhood_arrays(positions, types, number_particles_to_use=50) -> np.ndarray:
    """Stack ragged neighborhoods into [N, P, 12] via sort-clip feature maps."""
    return np.stack([per_particle_features(p, t, number_particles_to_use)
                     for p, t in zip(positions, types)])


def load_glass_splits(data_dir: str, protocol: str):
    """Raw (positions, types, labels) per split from a real {protocol}.npz,
    or None if it is missing."""
    path = os.path.join(data_dir, f"{protocol}.npz")
    if not os.path.exists(path):
        return None
    pkl = np.load(path, allow_pickle=True)
    out = {}
    for split in ("train", "val"):
        labels = np.squeeze(np.concatenate(pkl[f"{split}_is_loci"])).reshape(-1, 1)
        out[split] = (pkl[f"{split}_particle_positions"], pkl[f"{split}_types"],
                      labels.astype(np.float32))
    return out


def load_glass_protocol(data_dir: str, protocol: str, number_particles_to_use: int = 50):
    """Per-particle feature arrays per split from a real {protocol}.npz, or
    None if it is missing."""
    splits = load_glass_splits(data_dir, protocol)
    if splits is None:
        return None
    return {split: (build_neighborhood_arrays(pos, typ, number_particles_to_use), labels)
            for split, (pos, typ, labels) in splits.items()}


@register_dataset("amorphous_particles")
def fetch_amorphous_particles(data_path: str = "./data/", protocol: str = "GradualQuench",
                              number_particles_to_use: int = 50,
                              num_synthetic_neighborhoods: int = 2048, seed: int = 0,
                              **_) -> DatasetBundle:
    """Per-particle set dataset for the set-transformer workload.

    x arrays are flat [N, P * 12] (the bundle contract); ``extras`` carries
    the [N, P, 12] sets. y is the binary rearrangement-locus label. The
    synthetic fallback holds out the first 15% as validation.
    """
    real = load_glass_protocol(data_path, protocol, number_particles_to_use)
    if real is not None:
        (x_train, y_train), (x_valid, y_valid) = real["train"], real["val"]
        source = "real"
    else:
        pos, typ, labels = synthetic_glass_neighborhoods(num_synthetic_neighborhoods, seed=seed)
        feats = build_neighborhood_arrays(pos, typ, number_particles_to_use)
        n_valid = max(int(0.15 * len(labels)), 1)
        x_valid, y_valid = feats[:n_valid], labels[:n_valid]
        x_train, y_train = feats[n_valid:], labels[n_valid:]
        source = "synthetic"

    return DatasetBundle(
        x_train=x_train.reshape(x_train.shape[0], -1),
        y_train=y_train,
        x_valid=x_valid.reshape(x_valid.shape[0], -1),
        y_valid=y_valid,
        feature_dimensionalities=[PARTICLE_FEATURE_DIM]
        * (x_train.shape[1] if x_train.ndim == 3 else number_particles_to_use),
        output_dimensionality=1,
        loss="bce",
        loss_is_info_based=True,
        metrics=("accuracy",),
        extras={
            "sets_train": x_train,
            "sets_valid": x_valid,
            "protocol": protocol,
            "source": source,
            "number_particles_to_use": number_particles_to_use,
        },
    )


@register_dataset("amorphous_radial_shells")
def fetch_amorphous_radial_shells(data_path: str = "./data/", protocol: str = "GradualQuench",
                                  num_shells: int = 10, max_radius: float = 8.0,
                                  num_synthetic_neighborhoods: int = 4096, seed: int = 0,
                                  **_) -> DatasetBundle:
    """Radial-density-shell features for the standard Distributed IB model.

    Each neighborhood becomes ``2 * num_shells`` scalar features: the count
    of type-A and of type-B particles in each radial shell, divided by the
    shell's area, one bottleneck each. The real ``{protocol}.npz`` export is
    read when present; otherwise the synthetic neighborhoods, the first 15%
    held out.
    """
    real = load_glass_splits(data_path, protocol)
    if real is None:
        pos, typ, labels = synthetic_glass_neighborhoods(num_synthetic_neighborhoods, seed=seed)
        n_valid = max(int(0.15 * len(labels)), 1)
        splits = {
            "val": (pos[:n_valid], typ[:n_valid], labels[:n_valid]),
            "train": (pos[n_valid:], typ[n_valid:], labels[n_valid:]),
        }
    else:
        splits = real

    edges = np.linspace(0.0, max_radius, num_shells + 1)
    areas = np.pi * (edges[1:] ** 2 - edges[:-1] ** 2)

    def shell_features(positions, types):
        out = np.zeros((len(positions), 2 * num_shells), dtype=np.float32)
        for i, (p, t) in enumerate(zip(positions, types)):
            r = np.sqrt(np.sum(np.asarray(p) ** 2, -1))
            t = np.asarray(t).astype(np.int32).reshape(-1)
            for type_id in (1, 2):
                hist, _ = np.histogram(r[t == type_id], bins=edges)
                out[i, (type_id - 1) * num_shells: type_id * num_shells] = hist / areas
        return out

    labels = [f"shell{j}_r{edges[j]:.1f}-{edges[j + 1]:.1f}_type{t}"
              for t in "AB" for j in range(num_shells)]
    return DatasetBundle(
        x_train=shell_features(*splits["train"][:2]),
        y_train=splits["train"][2].astype(np.float32),
        x_valid=shell_features(*splits["val"][:2]),
        y_valid=splits["val"][2].astype(np.float32),
        feature_dimensionalities=[1] * (2 * num_shells),
        output_dimensionality=1,
        loss="bce",
        loss_is_info_based=True,
        metrics=("accuracy",),
        feature_labels=labels,
        extras={"protocol": protocol, "shell_edges": edges},
    )
