"""Fault injectors of the port (counterpart of ``dib_tpu/faults``).

Only the serve-scope injectors are ported
(:mod:`dib_tpu_torch.faults.serve`); fault plans (``DIB_FAULT_PLAN``) wait
for ROADMAP.md queue 1, item 3.
"""

from dib_tpu_torch.faults.serve import FlakyEngine, InjectedReplicaFault, kill_batcher_worker

__all__ = ["FlakyEngine", "InjectedReplicaFault", "kill_batcher_worker"]
