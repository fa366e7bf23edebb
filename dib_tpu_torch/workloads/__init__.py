"""Paper workloads of the port: the amorphous-plasticity flagship and its beta sweep."""

from dib_tpu_torch.workloads.amorphous import (
    AmorphousWorkloadConfig,
    ProbeGridHook,
    WorkloadDraws,
    build_model,
    pair_correlation,
    probe_features_for_type,
    probe_grid_positions,
    probe_info_maps,
    run_amorphous_protocols,
    run_amorphous_sweep,
    run_amorphous_workload,
)
