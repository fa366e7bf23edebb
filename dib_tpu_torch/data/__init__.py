"""Dataset registry and every dataset of the JAX package's registry: the
boolean circuit, the nine tabular datasets, the double pendulum, and the
amorphous per-particle sets and radial shells.

Importing this package registers every dataset; use
``dib_tpu_torch.data.get_dataset(name, **kwargs)``.
"""

from dib_tpu_torch.data.registry import (
    DatasetBundle,
    get_dataset,
    register_dataset,
)
from dib_tpu_torch.data import amorphous, boolean_circuit, pendulum, tabular  # noqa: F401
from dib_tpu_torch.data.boolean_circuit import (
    PAPER_CIRCUIT,
    apply_gates,
    exact_subset_informations,
    full_truth_table,
    random_circuit,
)
from dib_tpu_torch.data.pendulum import simulate_double_pendulum, total_energy, unroll_angles
from dib_tpu_torch.data.tabular import QuantileTransformer, TabularPreprocessor, read_csv
