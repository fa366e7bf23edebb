"""Per-particle information heat maps over a spatial probe grid
(counterpart of ``dib_tpu/viz/probe_maps.py``).

The [grid, grid] mean of the InfoNCE/LOO bounds in bits, optionally masked
by the pair-correlation density (NaN inside the excluded-volume core and
beyond the outermost occupied shell), drawn with 'gist_heat_r' per particle
type.
"""

from __future__ import annotations

import numpy as np

from dib_tpu_torch.viz import pyplot


def density_mask(probe_positions: np.ndarray, g_r: np.ndarray, g_r_bins: np.ndarray,
                 grid_side_length: int, density_threshold: float = 1e-6) -> np.ndarray:
    """[G, G] mask: NaN for probe points where g(r) < threshold (no physical
    particles there, so the network's output is meaningless), 1 elsewhere.

    ``g_r_bins`` holds the RIGHT edge of each g(r) bin, as many as ``g_r``
    (pass ``edges[1:]`` of ``pair_correlation``). Masks the excluded-volume
    core (the initial run of empty bins; empty bins between occupied shells
    do not widen it) and everything beyond the outermost occupied bin, where
    the asymmetric LOO upper bound diverges.
    """
    g_r_bins = np.asarray(g_r_bins)
    if len(g_r_bins) != len(np.asarray(g_r)):
        raise ValueError(
            f"g_r_bins must be the per-bin RIGHT edges (len == len(g_r)); got "
            f"{len(g_r_bins)} edges for {len(np.asarray(g_r))} bins; pass edges[1:] "
            "from pair_correlation")
    occupied = np.where(g_r >= density_threshold)[0]
    if len(occupied) == 0:
        inner_cutoff, outer_cutoff = 0.0, 0.0     # nothing supported
    else:
        inner_cutoff = 0.0 if occupied[0] == 0 else g_r_bins[occupied[0] - 1]
        outer_cutoff = g_r_bins[occupied[-1]]
    radii = np.hypot(probe_positions[:, 0], probe_positions[:, 1])
    mask = np.where((radii < inner_cutoff) | (radii > outer_cutoff), np.nan, 1.0)
    return mask.reshape(grid_side_length, grid_side_length)


def save_info_maps(info_bounds_grids, out_fname: str, masks=None, titles=None,
                   cmap: str = "gist_heat_r") -> str:
    """Render per-type probe-grid info maps side by side into ``out_fname``
    (PNG/SVG) and return it. ``info_bounds_grids`` are [G, G, 2] (lower,
    upper) in nats; ``masks`` optional [G, G] NaN-masks."""
    plt = pyplot("save_info_maps")
    num = len(info_bounds_grids)
    fig = plt.figure(figsize=(9 * num, 8))
    for i, grid in enumerate(info_bounds_grids):
        ax = fig.add_subplot(1, num, i + 1)
        img = np.mean(np.asarray(grid), axis=-1) / np.log(2.0)
        if masks is not None:
            img = img * masks[i]
        im = ax.imshow(img, cmap=cmap)
        ax.set_axis_off()
        if titles:
            ax.set_title(titles[i])
        fig.colorbar(im, ax=ax)
    fig.savefig(out_fname)
    plt.close(fig)
    return out_fname
