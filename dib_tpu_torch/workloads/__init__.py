"""Paper workloads of the port: the amorphous-plasticity flagship so far."""

from dib_tpu_torch.workloads.amorphous import AmorphousWorkloadConfig, build_model
