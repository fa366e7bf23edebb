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
