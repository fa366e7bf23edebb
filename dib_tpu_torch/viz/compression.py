"""Compression-scheme matrices: how distinguishable are a feature's values
in latent space? (counterpart of ``dib_tpu/viz/compression.py``).

Sort or sample the feature's values, compute exp(-Bhattacharyya)
distinguishability between their latent Gaussians, and render it with
marginal histograms (fewer than 10 unique values) or value curves. The row
selection and its ``rng.choice`` draw are the JAX package's, so one seed
displays the same rows in both.
"""

from __future__ import annotations

import numpy as np
import torch

from dib_tpu_torch.ops.gaussian import bhattacharyya_dist_mat
from dib_tpu_torch.viz import pyplot


def compression_matrix(mus, logvars) -> np.ndarray:
    """exp(-Bhattacharyya) distinguishability matrix in [0, 1] of [N, d]
    channel parameters (numpy or tensors), as numpy [N, N]."""
    mus, logvars = (torch.as_tensor(np.asarray(a)) for a in (mus, logvars))
    return np.exp(-bhattacharyya_dist_mat(mus, logvars, mus, logvars).numpy())


def save_compression_matrix(mus, logvars, raw_values, out_fname: str,
                            feature_label: str | None = None,
                            max_number_to_display: int = 128,
                            rng: np.random.Generator | None = None) -> str:
    """Render one feature's compression matrix with marginals into
    ``out_fname`` (PNG) and return it.

    ``mus``/``logvars`` are [N, d] channel parameters of the feature's data
    points, aligned with ``raw_values`` ([N] or [N, 1] raw feature values,
    which order the axes and give the marginals). With fewer than 10
    unique values it shows one row per value in ascending order; otherwise
    up to ``max_number_to_display`` rows drawn without replacement from
    ``rng``, sorted by value.
    """
    rng = rng or np.random.default_rng(0)
    raw = np.asarray(raw_values).reshape(len(raw_values), -1)[:, 0]
    unique_vals, unique_idx = np.unique(raw, return_index=True)
    if len(unique_vals) < 10:          # one row per value, its frequency in the marginals
        order = np.argsort(unique_vals)
        sel, sorted_raw = unique_idx[order], unique_vals[order]
        counts = np.array([np.mean(raw == v) for v in sorted_raw])
    else:                              # a sample of rows, sorted by value
        pick = rng.choice(len(raw), min(max_number_to_display, len(raw)), replace=False)
        sel = pick[np.argsort(raw[pick])]
        sorted_raw, counts = raw[sel], None
    mat = compression_matrix(np.asarray(mus)[sel], np.asarray(logvars)[sel])
    n = len(sel)

    plt = pyplot("save_compression_matrix")
    fig = plt.figure(figsize=(6, 6))
    gs = fig.add_gridspec(2, 2, width_ratios=(1, 2), height_ratios=(1, 2), left=0.1,
                          right=0.9, bottom=0.1, top=0.9, wspace=0.05, hspace=0.05)
    ax = fig.add_subplot(gs[1, 1])
    ax.imshow(mat, vmin=0, vmax=1, cmap="Blues_r")
    ax.set_axis_off()

    ax_left = fig.add_subplot(gs[1, 0])
    ax_top = fig.add_subplot(gs[0, 1])
    if counts is not None:
        ax_left.barh(sorted_raw, counts, height=0.8)
        ax_left.set_xlim(0, 1)
        ax_left.set_xticks([])
        ax_top.bar(sorted_raw, counts, width=0.8)
        ax_top.set_ylim(0, 1)
        ax_top.set_yticks([])
    else:
        ax_left.plot(sorted_raw, np.arange(n), "k", lw=3)
        ax_left.set_ylim(n, 0)
        ax_left.set_yticks([])
        ax_top.plot(np.arange(n), sorted_raw, "k", lw=3)
        ax_top.set_xlim(0, n)
        ax_top.set_xticks([])
    for a in (ax_left, ax_top):
        for side in ("top", "right", "left", "bottom"):
            a.spines[side].set_visible(False)

    ax_label = fig.add_subplot(gs[0, 0])
    if feature_label:
        ax_label.text(0, 0, feature_label)
    ax_label.set_xlim(-0.5, 0.5)
    ax_label.set_ylim(-0.5, 0.5)
    ax_label.set_axis_off()

    fig.savefig(out_fname)
    plt.close(fig)
    return out_fname
