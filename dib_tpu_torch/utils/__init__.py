"""Host-side utilities of the port (counterpart of ``dib_tpu/utils``)."""
