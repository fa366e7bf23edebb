"""Channel math, MI bounds and the hand-written kernels.

Submodules are imported directly (``dib_tpu_torch.ops.gaussian`` etc.) so
that the numpy-only data modules can use ``ops.entropy`` without torch.
"""
