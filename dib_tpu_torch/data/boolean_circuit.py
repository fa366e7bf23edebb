"""Boolean-circuit dataset: exhaustive truth tables of a gate circuit.

Counterpart of ``dib_tpu/data/boolean_circuit.py`` (the paper circuit or a
random circuit, full 2^n truth-table evaluation, inputs mapped to [-1, 1]).
"""

from __future__ import annotations

import numpy as np

from dib_tpu_torch.data.registry import DatasetBundle, register_dataset
from dib_tpu_torch.ops.entropy import mutual_information_bits, sequence_entropy_bits

GATES = (np.logical_and, np.logical_or, np.logical_xor)

# The 10-input circuit from the paper: each bracketed entry defines an
# intermediate gate as [gate_id, input1, input2].
PAPER_CIRCUIT = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
    [1, 0, 1], [2, 8, 7], [0, 4, 3], [1, 11, 5], [2, 6, 12],
    [2, 13, 9], [1, 14, 10], [0, 15, 2], [0, 17, 16],
]


def num_circuit_inputs(circuit_specification) -> int:
    return sum(1 for v in circuit_specification if isinstance(v, (int, np.integer)))


def random_circuit(num_inputs: int, rng: np.random.Generator) -> list:
    """Random binary-tree circuit: combine two live wires with a random gate
    until one output remains."""
    spec: list = list(range(num_inputs))
    live = list(range(num_inputs))
    while len(live) > 1:
        gate = int(rng.integers(len(GATES)))
        a, b = rng.choice(live, size=2, replace=False)
        live.append(len(spec))
        live.remove(int(a))
        live.remove(int(b))
        spec.append([gate, int(a), int(b)])
    return spec


def apply_gates(inputs: np.ndarray, circuit_specification) -> np.ndarray:
    """Evaluate the circuit columnwise: returns inputs + all intermediate gate
    outputs appended (final column = circuit output)."""
    table = np.asarray(inputs, dtype=np.int64)
    for spec in circuit_specification[table.shape[-1]:]:
        gate_id, a, b = spec
        col = GATES[gate_id](table[:, a], table[:, b]).astype(np.int64)
        table = np.concatenate([table, col[:, None]], axis=-1)
    return table


def full_truth_table(circuit_specification) -> np.ndarray:
    """[2^n, n + num_gates] exhaustive evaluation."""
    n = num_circuit_inputs(circuit_specification)
    grids = np.meshgrid(*[[0, 1]] * n)
    inputs = np.stack(grids, -1).reshape(-1, n)
    return apply_gates(inputs, circuit_specification)


def exact_subset_informations(truth_table: np.ndarray, num_inputs: int) -> dict:
    """Exact MI (bits) of EVERY input subset with the output: the ground
    truth the DIB allocation is held to. Returns {subset (tuple of input
    indices): MI in bits}, the empty subset included."""
    y = truth_table[:, -1]
    out = {(): 0.0}
    for mask in range(1, 2 ** num_inputs):
        subset = tuple(i for i in range(num_inputs) if (mask >> i) & 1)
        out[subset] = mutual_information_bits(truth_table[:, list(subset)], y)
    return out


@register_dataset("boolean_circuit")
def fetch_boolean_circuit(
    boolean_random_circuit: bool = False,
    boolean_number_input_gates: int = 10,
    seed: int = 0,
    circuit_specification=None,
    **_,
) -> DatasetBundle:
    """Truth-table dataset; train == valid (the table IS the population)."""
    if circuit_specification is not None:
        spec = circuit_specification
    elif boolean_random_circuit:
        spec = random_circuit(boolean_number_input_gates, np.random.default_rng(seed))
    else:
        spec = PAPER_CIRCUIT
    n = num_circuit_inputs(spec)

    table = full_truth_table(spec)
    x = (2 * table[:, :n] - 1).astype(np.float32)   # {0,1} -> {-1,+1}
    y = table[:, -1].astype(np.float32)[:, None]

    return DatasetBundle(
        x_train=x,
        y_train=y,
        x_valid=x,
        y_valid=y,
        feature_dimensionalities=[1] * n,
        output_dimensionality=1,
        loss="bce",
        loss_is_info_based=True,
        metrics=("accuracy",),
        extras={
            "circuit_specification": spec,
            "truth_table": table,
            "entropy_y_bits": sequence_entropy_bits(table[:, -1]),
        },
    )
