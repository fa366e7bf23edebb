"""Deterministic fault injection (counterpart of ``dib_tpu/faults``).

  - :mod:`~dib_tpu_torch.faults.plan`: the ``DIB_FAULT_PLAN`` grammar
    (``stall@chunk3:45s,kill@chunk5,nan@chunk7``), the fault-kind registry
    and fired-once marks that survive the faults' own kills;
  - :mod:`~dib_tpu_torch.faults.inject`: the train-scope executors the
    fits apply at chunk boundaries, ``PoisonedReplicaRestore`` and
    checkpoint corruption of the port's format;
  - :mod:`~dib_tpu_torch.faults.serve`: the serve-scope injectors.

``tear_journal`` and ``expire_lease`` (the scheduler's) wait for
ROADMAP.md queue 1, item 6.
"""

from dib_tpu_torch.faults.inject import (
    SDC_SCALE,
    PoisonedReplicaRestore,
    apply_due_train_faults,
    corrupt_checkpoint,
    poison_params,
    poison_replica_params,
    scale_params,
    scale_replica_params,
)
from dib_tpu_torch.faults.plan import FAULT_KINDS, FaultPlan, FaultSpec
from dib_tpu_torch.faults.serve import FlakyEngine, InjectedReplicaFault, kill_batcher_worker

__all__ = ["FAULT_KINDS", "SDC_SCALE", "FaultPlan", "FaultSpec", "FlakyEngine",
           "InjectedReplicaFault", "PoisonedReplicaRestore", "apply_due_train_faults",
           "corrupt_checkpoint", "kill_batcher_worker", "poison_params",
           "poison_replica_params", "scale_params", "scale_replica_params"]
