"""Plots of the port (counterparts of ``dib_tpu/viz/``).

matplotlib is imported inside each ``save_*`` function, never when a module
is imported, so the port runs where matplotlib is not installed; there the
drivers are called with ``render=False``.
"""


def pyplot(caller: str):
    """``matplotlib.pyplot`` on the Agg backend; raises ``ImportError``
    naming ``caller`` when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(f"{caller} needs matplotlib, which is not installed; "
                          "run the driver with render=False") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


from dib_tpu_torch.viz.compression import (  # noqa: E402  (they import pyplot from here)
    compression_matrix,
    save_compression_matrix,
)
from dib_tpu_torch.viz.info_plane import save_distributed_info_plane  # noqa: E402
from dib_tpu_torch.viz.probe_maps import density_mask, save_info_maps  # noqa: E402
