"""Fault executors: the code that breaks things on purpose (counterpart of
``dib_tpu/faults/inject.py``).

:func:`apply_due_train_faults` runs inside ``DIBTrainer.fit`` and
``BetaSweepTrainer.fit`` at chunk boundaries, after the boundary's hooks,
so a checkpoint hook has already saved the clean state: a ``nan`` fault
poisons the state the next chunk trains on, never the state on disk.
:func:`corrupt_checkpoint` damages a ``DIBCheckpointer`` directory of the
port's own format. Every executor writes a ``fault`` event before it acts.
The weights are changed in place (a state's modules are its parameters).

Not ported: ``tear_journal`` and ``expire_lease``, which act on the
scheduler (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import os
import signal
import sys
import time
import zipfile

import torch

from dib_tpu_torch.faults.plan import FaultPlan, FaultSpec

__all__ = ["SDC_SCALE", "PoisonedReplicaRestore", "apply_due_train_faults",
           "corrupt_checkpoint", "poison_params", "poison_replica_params", "scale_params",
           "scale_replica_params"]

#: Finite corruption factor of the ``replica_sdc`` kind (its arg names the
#: member): large enough to leave the detector's robust band, small enough
#: that the next chunk stays finite.
SDC_SCALE = 4.0


def _sorted_parameters(params) -> list[tuple[str, torch.Tensor]]:
    """The module's parameters in name order (the JAX package's path order)."""
    leaves = sorted(params.named_parameters(), key=lambda item: item[0])
    if not leaves:
        raise ValueError("cannot corrupt a module without parameters")
    return leaves


def poison_params(params, value: float):
    """Set the first (name-sorted) parameter of ``params`` (a module) to
    ``value``, in place; one fully poisoned leaf makes the next forward
    non-finite whatever the architecture. Returns ``params``."""
    with torch.no_grad():
        _sorted_parameters(params)[0][1].fill_(value)
    return params


def scale_params(params, factor: float):
    """Scale every parameter by a finite ``factor``, in place: silent data
    corruption that only the anomaly detector sees. Returns ``params``."""
    with torch.no_grad():
        for _, leaf in _sorted_parameters(params):
            leaf.mul_(factor)
    return params


def _member_axis(params, name: str, leaf: torch.Tensor) -> torch.Tensor:
    """A view of a stacked parameter of ``params`` (a trainer's
    ``ModuleDict`` or a model) that leads with the replica axis."""
    model = params
    if isinstance(params, torch.nn.ModuleDict) and "model" in params:
        model, name = params["model"], name.removeprefix("model.")
    axis = getattr(model, "member_axis", None)
    return leaf if axis is None else axis(name, leaf)


def _check_member(leaf: torch.Tensor, replica: int, kind: str) -> None:
    if leaf.dim() < 1 or not 0 <= replica < leaf.shape[0]:
        raise ValueError(f"{kind} target {replica} is out of range for a stacked leaf of shape "
                         f"{tuple(leaf.shape)}: the fault targets a sweep member in [0, R)")


def scale_replica_params(params, replica: int, factor: float):
    """Finite corruption of ONE sweep member: member ``replica``'s slice of
    every stacked [R, ...] parameter scaled by ``factor``, in place."""
    with torch.no_grad():
        for name, leaf in _sorted_parameters(params):
            member = _member_axis(params, name, leaf)
            _check_member(member, replica, "replica_sdc")
            member[replica].mul_(factor)
    return params


def poison_replica_params(params, replica: int, value: float):
    """Poison ONE sweep member: member ``replica``'s slice of the first
    (name-sorted) stacked parameter set to ``value``, in place; the other
    members' slices are untouched."""
    member = _member_axis(params, *_sorted_parameters(params)[0])
    _check_member(member, replica, "replica_nan")
    with torch.no_grad():
        member[replica].fill_(value)
    return params


class PoisonedReplicaRestore:
    """A checkpointer whose every restore comes back with member
    ``replica`` poisoned: each quarantine replay then diverges again, so
    the sweep must eject the member. Everything else passes through to the
    wrapped :class:`~dib_tpu_torch.train.checkpoint.DIBCheckpointer`."""

    def __init__(self, checkpointer, replica: int, value: float = float("nan"),
                 telemetry=None):
        self._ckpt = checkpointer
        self._replica = int(replica)
        self._value = float(value)
        self._telemetry = telemetry
        self.poisoned_restores = 0

    def _poison(self, restored):
        state, history, generators = restored
        self.poisoned_restores += 1
        if self._telemetry is not None:
            self._telemetry.fault(kind="replica_nan", replica=self._replica,
                                  via="poisoned_restore")
        poison_replica_params(state.params, self._replica, self._value)
        return state, history, generators

    def restore(self, *args, **kwargs):
        return self._poison(self._ckpt.restore(*args, **kwargs))

    def restore_latest_intact(self, *args, **kwargs):
        return self._poison(self._ckpt.restore_latest_intact(*args, **kwargs))

    def __getattr__(self, attr):
        return getattr(self._ckpt, attr)


def _emit_fault(telemetry, spec: FaultSpec, **fields) -> None:
    if telemetry is not None:
        telemetry.fault(kind=spec.kind, spec=spec.raw, chunk=spec.chunk,
                        **({"arg": spec.arg} if spec.arg is not None else {}), **fields)


def apply_due_train_faults(plan: FaultPlan, chunk_index: int, state, telemetry=None,
                           log=lambda m: print(m, file=sys.stderr, flush=True)):
    """Fire every spec due at this (1-based) boundary, each marked fired
    before it acts (``kill`` never returns); returns ``state``, whose
    weights a ``nan``/``inf``/``sdc`` fault changed in place."""
    for spec in plan.due(chunk_index):
        plan.mark_fired(spec)
        epoch = int(state.epoch)
        extra = {"replica": int(spec.arg)} if spec.kind in ("replica_nan", "replica_sdc") else {}
        _emit_fault(telemetry, spec, epoch=epoch, **extra)
        log(f"fault injection: {spec.raw} firing at chunk boundary {chunk_index} "
            f"(epoch {epoch})")
        if spec.kind == "stall":
            time.sleep(float(spec.arg))
        elif spec.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif spec.kind == "preempt":
            os.kill(os.getpid(), signal.SIGTERM)
        elif spec.kind in ("nan", "inf"):
            poison_params(state.params, float("nan") if spec.kind == "nan" else float("inf"))
        elif spec.kind == "replica_nan":
            poison_replica_params(state.params, int(spec.arg), float("nan"))
        elif spec.kind == "sdc":
            scale_params(state.params, float(spec.arg))
        elif spec.kind == "replica_sdc":
            scale_replica_params(state.params, int(spec.arg), SDC_SCALE)
        else:   # parse() rejects other scopes
            raise ValueError(f"fault kind {spec.kind!r} is not train-scoped")
    return state


def _newest_step_dir(directory: str) -> str:
    steps = [d for d in os.listdir(directory)
             if d.isdigit() and os.path.isdir(os.path.join(directory, d))]
    if not steps:
        raise FileNotFoundError(f"no checkpoint step directories under {directory}")
    return os.path.join(directory, max(steps, key=int))


def _largest_leaf(npz_path: str) -> tuple[str, int, int]:
    """(name, byte offset, size) of the largest array stored in an
    uncompressed ``.npz``."""
    with zipfile.ZipFile(npz_path) as archive:
        info = max(archive.infolist(), key=lambda i: i.file_size)
    with open(npz_path, "rb") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = (int.from_bytes(f.read(2), "little") for _ in range(2))
    return info.filename, info.header_offset + 30 + name_len + extra_len, info.compress_size


def corrupt_checkpoint(directory: str, mode: str, telemetry=None,
                       step: int | None = None) -> dict:
    """Damage a ``DIBCheckpointer`` directory the way hardware would.

    Modes:
      - ``ckpt_truncate``: the newest step's ``leaves.npz`` (its largest
        file) cut to half its size (a torn write);
      - ``ckpt_bitflip_manifest``: one byte in the middle of the newest
        step's ``manifest.json`` XORed (bit rot);
      - ``ckpt_bitflip_payload``: one bit flipped in the middle of the
        largest leaf inside ``leaves.npz`` of step ``step`` (default the
        newest), the file's structure intact.

    Returns what was damaged; writes a ``fault`` event when ``telemetry``
    is given.
    """
    from dib_tpu_torch.train.checkpoint import LEAVES_FILENAME, MANIFEST_FILENAME

    if step is not None and mode != "ckpt_bitflip_payload":
        raise ValueError(f"corrupt_checkpoint mode {mode!r} does not take a step "
                         "(only ckpt_bitflip_payload targets a specific step)")
    step_dir = (_newest_step_dir(directory) if step is None
                else os.path.join(directory, str(step)))
    leaves = os.path.join(step_dir, LEAVES_FILENAME)
    if mode == "ckpt_bitflip_payload":
        name, offset, size = _largest_leaf(leaves)
        pos = offset + size // 2
        with open(leaves, "rb+") as f:
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0x01]))
        detail = {"kind": mode, "path": leaves, "leaf": name, "flipped_byte": pos,
                  "flipped_bit": 0, "step_dir": step_dir}
    elif mode == "ckpt_truncate":
        size = os.path.getsize(leaves)
        with open(leaves, "rb+") as f:
            f.truncate(size // 2)
        detail = {"kind": mode, "path": leaves, "bytes_before": size,
                  "bytes_after": size // 2, "step_dir": step_dir}
    elif mode == "ckpt_bitflip_manifest":
        path = os.path.join(step_dir, MANIFEST_FILENAME)
        with open(path, "rb") as f:
            blob = bytearray(f.read())
        pos = len(blob) // 2
        blob[pos] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        detail = {"kind": mode, "path": path, "flipped_byte": pos, "step_dir": step_dir}
    else:
        raise ValueError(f"unknown checkpoint corruption mode {mode!r} (ckpt_truncate | "
                         "ckpt_bitflip_manifest | ckpt_bitflip_payload)")
    if telemetry is not None:
        telemetry.fault(**detail)
    return detail
