"""dib_tpu_torch: the Distributed Information Bottleneck on PyTorch and CUDA.

The PyTorch counterpart of ``dib_tpu`` (the JAX/TPU package, which stays the
reference). Module layout and names follow ``dib_tpu`` so each counterpart
is easy to find. Plain tensor code is PyTorch; every kernel that ``dib_tpu``
wrote in Pallas for the TPU is a CUDA C++ kernel for Hopper under
``dib_tpu_torch/csrc``, built with ``nvcc`` on first use and bound through
ctypes, with a plain PyTorch version beside it that CPU tensors take.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no GPU they raise rather than fall back.
"""

__version__ = "0.1.0"

# PEP 562 lazy submodule access: importing the package imports no torch.
_SUBMODULES = ("data", "faults", "interop", "models", "ops", "parallel", "serve", "telemetry",
               "train", "workloads")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        module = importlib.import_module(f"dib_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'dib_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
