"""The distributed information plane (counterpart of
``dib_tpu/viz/info_plane.py``).

Loss against total KL (black, thick) with per-feature KL curves on a twin
axis and an optional H(Y) guide line, saved as
``distributed_info_plane.png``; series sieved to at most ~1000 points and
the first half skipped (warmup).
"""

from __future__ import annotations

import os

import numpy as np

from dib_tpu_torch.viz import pyplot


def save_distributed_info_plane(kl_series: np.ndarray, loss_series: np.ndarray, outdir: str,
                                entropy_y: float | None = None, info_plot_lims=(0.0, 15.0),
                                filename: str = "distributed_info_plane.png",
                                skip_fraction: float = 0.5) -> str:
    """Plot the info-plane trajectory and return the saved path.

    ``kl_series`` is [T, F] per-feature KL (bits), ``loss_series`` [T] task
    loss (bits if info-based); ``entropy_y`` an optional H(Y) guide line
    (bits); ``info_plot_lims`` the x-axis limits; ``skip_fraction`` the share
    of the sieved series skipped as warmup.
    """
    plt = pyplot("save_distributed_info_plane")
    os.makedirs(outdir, exist_ok=True)
    kl_series = np.asarray(kl_series)
    loss_series = np.asarray(loss_series)
    num_features = kl_series.shape[1]

    target_len = min(1000, kl_series.shape[0])
    sieve = max(kl_series.shape[0] // target_len, 1)
    kl = kl_series[::sieve]
    loss = loss_series[::sieve]
    start = int(kl.shape[0] * skip_fraction)
    total_kl = kl.sum(-1)

    fig = plt.figure(figsize=(8, 4))
    ax = plt.gca()
    ax.plot(total_kl[start:], loss[start:], lw=4, color="k")
    if entropy_y is not None:
        ax.plot(list(info_plot_lims), [entropy_y] * 2, "k:")
    ax.set_xlim(info_plot_lims)
    ax.set_xlabel("Total information into model (bits)")
    ax.set_ylabel("Task loss (bits)")
    if num_features > 1:
        colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
        ax2 = ax.twinx()
        for f in range(num_features):
            ax2.plot(total_kl[start:], kl[start:, f], color=colors[f % len(colors)], lw=3)
        ax2.set_ylabel("Information per feature (bits)")
        ax.set_zorder(ax2.get_zorder() + 1)
        ax.patch.set_visible(False)

    path = os.path.join(outdir, filename)
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path
