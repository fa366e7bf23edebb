"""Dataset registry and the datasets the port has so far: the boolean
circuit and the amorphous per-particle sets.

Importing this package registers every dataset; use
``dib_tpu_torch.data.get_dataset(name, **kwargs)``.
"""

from dib_tpu_torch.data.registry import (
    DatasetBundle,
    get_dataset,
    register_dataset,
)
from dib_tpu_torch.data import amorphous, boolean_circuit  # noqa: F401  (registers)
from dib_tpu_torch.data.boolean_circuit import (
    PAPER_CIRCUIT,
    apply_gates,
    full_truth_table,
    random_circuit,
)
