"""Paper workloads of the port: the amorphous-plasticity flagship and its
beta sweep, the boolean circuit, the bounds' characterization and the
radial shells."""

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
from dib_tpu_torch.workloads.boolean import (
    BooleanDIBModel,
    BooleanTrainer,
    BooleanWorkloadConfig,
    allocation_rank_agreement,
    best_subsets_by_size,
    logistic_regression_importances,
    run_boolean_workload,
    shapley_values_bits,
)
from dib_tpu_torch.workloads.characterization import (
    CharacterizationResult,
    SyntheticChannel,
    estimate_bounds_bits,
    monte_carlo_mi_bits,
    run_characterization,
    save_characterization_plots,
)
from dib_tpu_torch.workloads.radial_shells import RadialShellsConfig, run_radial_shells_workload
