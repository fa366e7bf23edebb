"""Seeded fault plans: what breaks, where, on purpose (counterpart of
``dib_tpu/faults/plan.py``)::

    DIB_FAULT_PLAN=stall@chunk3:45s,kill@chunk5,nan@chunk7

Each spec is ``kind@chunkN[:ARG]``: fire fault ``kind`` at the N-th fit
chunk boundary (1-based, counted per process launch). The fit applies due
specs after the boundary's hooks, writes a ``fault`` event for each, and
marks the spec fired in ``state_dir`` before acting, so a worker killed by
its own fault and relaunched does not fire it again.

:data:`FAULT_KINDS` is the JAX package's registry; only the ``train``
scope is injectable through the grammar. Checkpoint corruption is
injected by :func:`dib_tpu_torch.faults.inject.corrupt_checkpoint`, the
serve faults by :mod:`dib_tpu_torch.faults.serve`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Sequence

__all__ = ["FAULT_KINDS", "FaultPlan", "FaultSpec"]

PLAN_ENV = "DIB_FAULT_PLAN"
STATE_DIR_ENV = "DIB_FAULT_STATE_DIR"

# kind -> (scope, arg meaning or None, description). Scope "train" = plan-
# grammar injectable at fit chunk boundaries; "checkpoint"/"serve"/"http" =
# injected through dib_tpu_torch.faults.inject / .serve.
FAULT_KINDS: dict[str, tuple[str, str | None, str]] = {
    "stall": ("train", "seconds",
              "simulated device stall: sleep inside the heartbeat-visible "
              "window so the watchdog's trailing-median timeout fires"),
    "kill": ("train", None,
             "SIGKILL the worker process at the boundary (after its "
             "checkpoint hook ran) — the crash-restart path"),
    "nan": ("train", None,
            "poison one param leaf with NaN so the next chunk's loss/KL "
            "are non-finite — the divergence-rollback path"),
    "inf": ("train", None,
            "poison one param leaf with +Inf (same detector as 'nan')"),
    "ckpt_truncate": ("checkpoint", None,
                      "truncate the largest file of the latest checkpoint step "
                      "dir (torn write / partial flush)"),
    "ckpt_bitflip_manifest": ("checkpoint", None,
                              "flip one byte of the newest step's manifest.json (bit rot "
                              "/ torn manifest write)"),
    "replica_error": ("serve", "count",
                      "a serve replica whose dispatches raise — the "
                      "consecutive-failure ejection path"),
    "replica_slow": ("serve", "seconds",
                     "a serve replica whose dispatches sleep past request "
                     "deadlines — ejection via timeout failures"),
    "batcher_crash": ("serve", None,
                      "kill a micro-batcher's worker thread — the truthful "
                      "/healthz 503 path"),
    "http_malformed": ("http", None,
                       "invalid JSON / wrong-width rows / dropped "
                       "connections against the HTTP server"),
    "replica_nan": ("train", "replica",
                    "poison ONE sweep member's params slice with NaN — "
                    "the per-replica divergence quarantine / ejection "
                    "path (sweep fits; arg = replica index)"),
    "preempt": ("train", None,
                "SIGTERM own process at the boundary — the cooperative "
                "preemption path: chunk-aligned checkpoint, 'preempted' "
                "run status, distinct exit the watchdog relaunches "
                "without backoff"),
    "desync": ("multihost", None,
               "one host arrives at the chunk barrier with a stale "
               "(run_id, chunk, git_sha) — the desync guard names it "
               "instead of hanging; injected by the drill harness"),
    "sdc": ("train", "scale",
            "silent data corruption: scale every param leaf by a FINITE "
            "factor so the next boundary's metrics are garbage but never "
            "NaN — the β-aware anomaly-rollback path (train/anomaly.py); "
            "arg = the scale factor"),
    "replica_sdc": ("train", "replica",
                    "finite SDC on ONE sweep member: scale member r's "
                    "param slices so its lane goes anomalous without a "
                    "NaN — the per-replica anomaly quarantine/ejection "
                    "path (arg = replica index; the scale factor is "
                    "faults.inject.SDC_SCALE)"),
    "ckpt_bitflip_payload": ("checkpoint", None,
                             "flip ONE BIT in a retained step's payload "
                             "bytes (structure intact, bytes wrong) — "
                             "the content-digest / scrub detection path "
                             "(manifest schema v3)"),
    "sched_worker_kill": ("sched", "chunk",
                          "kill one pool worker dead mid-unit (no release, "
                          "no fail — its lease just goes silent): the "
                          "pool degrades to N-1 and the reaper steals the "
                          "unit for a live worker, which resumes it from "
                          "its newest intact checkpoint"),
    "lease_expire": ("sched", None,
                     "force a held lease past its deadline while the "
                     "holder still runs — the work-stealing path: a live "
                     "worker re-leases the unit, and the stale holder's "
                     "renewal/completion is REJECTED (no double-execution)"),
    "journal_torn": ("sched", None,
                     "tear the scheduler journal mid-append (the SIGKILL-"
                     "mid-write shape) — replay on scheduler restart skips "
                     "the torn line, recovers the queue, and surfaces a "
                     "journal_recovered mitigation"),
}

# Plan-grammar kinds whose ARG is mandatory (the others default sensibly).
_ARG_REQUIRED = ("stall", "replica_nan", "sdc", "replica_sdc")

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@chunk(?P<chunk>\d+)(?::(?P<arg>[\d.]+)s?)?$"
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned injection: ``kind`` at the ``chunk``-th fit boundary."""

    kind: str
    chunk: int
    arg: float | None
    raw: str

    @property
    def marker(self) -> str:
        """Filename marking this spec fired (state survives SIGKILL).

        The arg participates so two same-kind specs at one boundary with
        different args (e.g. two replica_nan targets) fire independently.
        """
        suffix = "" if self.arg is None else f"_{self.arg:g}"
        return f"fault_fired_{self.kind}_chunk{self.chunk}{suffix}"


class FaultPlan:
    """A parsed, once-only-per-spec fault schedule.

    ``state_dir``: where fired-markers persist. Without one, fired state is
    in-memory only — fine for in-process drills, but a plan that SIGKILLs
    its own process NEEDS a directory or the relaunch re-fires it.
    """

    def __init__(self, specs: Sequence[FaultSpec], state_dir: str | None = None):
        self.specs = list(specs)
        self.state_dir = state_dir
        self._fired_memory: set[str] = set()
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)

    # ------------------------------------------------------------- parsing
    @classmethod
    def parse(cls, text: str, state_dir: str | None = None) -> "FaultPlan":
        specs = []
        for token in filter(None, (t.strip() for t in text.split(","))):
            m = _SPEC_RE.match(token)
            if m is None:
                raise ValueError(
                    f"Unparseable fault spec {token!r}; expected "
                    "kind@chunkN[:SECONDSs], e.g. stall@chunk3:45s"
                )
            kind = m.group("kind")
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"Unknown fault kind {kind!r}; known kinds: "
                    f"{sorted(FAULT_KINDS)}"
                )
            scope, arg_name, _ = FAULT_KINDS[kind]
            if scope != "train":
                raise ValueError(
                    f"Fault kind {kind!r} has scope {scope!r} — it is "
                    "injected through dib_tpu_torch.faults.inject or .serve, "
                    "not through the chunk-boundary plan grammar"
                )
            arg = m.group("arg")
            if kind in _ARG_REQUIRED and arg is None:
                example = ("stall@chunk3:45s" if kind == "stall"
                           else f"{kind}@chunk3:1")
                raise ValueError(
                    f"Fault spec {token!r} needs an argument "
                    f"({arg_name}), e.g. {example}"
                )
            specs.append(FaultSpec(
                kind=kind, chunk=int(m.group("chunk")),
                arg=float(arg) if arg is not None else None, raw=token,
            ))
        return cls(specs, state_dir=state_dir)

    @classmethod
    def from_env(cls, state_dir: str | None = None) -> "FaultPlan | None":
        """The env-driven entry point (``DIB_FAULT_PLAN``); None when unset.

        ``DIB_FAULT_STATE_DIR`` overrides the caller's ``state_dir`` (the
        drill harness pins one so fired-markers survive worker relaunches).
        """
        text = os.environ.get(PLAN_ENV, "")
        if not text:
            return None
        return cls.parse(text, state_dir=os.environ.get(STATE_DIR_ENV) or state_dir)

    # ----------------------------------------------------------- firing
    def fired(self, spec: FaultSpec) -> bool:
        if spec.marker in self._fired_memory:
            return True
        if self.state_dir:
            return os.path.exists(os.path.join(self.state_dir, spec.marker))
        return False

    def mark_fired(self, spec: FaultSpec) -> None:
        """Record the spec as fired BEFORE executing it — a kill fault must
        leave its marker behind or the relaunched worker repeats it."""
        self._fired_memory.add(spec.marker)
        if self.state_dir:
            path = os.path.join(self.state_dir, spec.marker)
            with open(path, "w") as f:
                f.write(spec.raw + "\n")

    def due(self, chunk_index: int) -> list[FaultSpec]:
        """Not-yet-fired specs scheduled for this (1-based) boundary."""
        return [s for s in self.specs
                if s.chunk == chunk_index and not self.fired(s)]

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan({', '.join(s.raw for s in self.specs)})"
