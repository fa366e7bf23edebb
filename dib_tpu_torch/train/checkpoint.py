"""Checkpoint and resume (counterpart of ``dib_tpu/train/checkpoint.py``).

The JAX package writes Orbax checkpoints; Orbax imports JAX, so the port
keeps a format of its own. Each step is one directory,
``<directory>/<step>/``, holding

  - ``leaves.npz``: every leaf as a plain numpy array, read back with
    ``allow_pickle=False`` (nothing is unpickled): ``params/<name>`` (the
    trained modules' state dict), ``optimizer/<i>/<slot>`` (Adam's moments
    and step counts, per parameter in the optimizer's order),
    ``schedule/last_epoch`` (the LR schedule's count of updates), ``epoch``,
    ``history/<field>`` and ``history/cursor``, ``chunk_size``, and
    ``generators/<r>``: the state of every ``torch.Generator`` that draws
    for training, as uint8 (one for a serial run, R for a sweep);
  - ``manifest.json``: the schema version, the param-structure hash and
    rows, and a sha256 per leaf, re-checked on every restore.

A step is written under a staging name, fsynced and renamed into place, so
a reader never sees half a step; the newest ``max_to_keep`` steps are kept.
A step that does not read back intact (truncated, a flipped byte) raises
:class:`CheckpointCorruptionError`; :meth:`DIBCheckpointer.
restore_latest_intact` moves such a step into ``quarantine/`` (never
deletes it) and falls back to the newest intact one.

A resumed run continues the same draws (the generators' states) on the same
chunk grid: ``restore(chunk_size=...)`` refuses a continuation with another
``hook_every``, as the JAX package does, so the continuation is
bit-identical to an uninterrupted run. The JAX manifest's mesh block does
not apply on one device and is left out.

Usage::

    ckpt = DIBCheckpointer(directory)
    trainer.fit(generator, hooks=[CheckpointHook(ckpt)], hook_every=100)
    ...
    state, history, generator = ckpt.restore(trainer, chunk_size=100)
    trainer.fit(generator, num_epochs=remaining, state=state, history=history,
                hooks=[CheckpointHook(ckpt)], hook_every=100)
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import zipfile

import numpy as np
import torch

CHECKPOINT_SCHEMA_VERSION = 1
MANIFEST_FILENAME = "manifest.json"
LEAVES_FILENAME = "leaves.npz"
QUARANTINE_DIRNAME = "quarantine"
_STAGING = ".staging-"


class CheckpointCorruptionError(RuntimeError):
    """A step exists but does not read back intact (truncated file, flipped
    byte, torn write). Distinct from ``ValueError`` (a wrong template or a
    broken chunk contract, wrong at every step): corruption is recovered by
    falling back to an earlier step."""


# ------------------------------------------------------------------ manifest

def param_structure_rows(params) -> list[str]:
    """Canonical ``"name [shape] dtype"`` row per parameter, sorted: two
    checkpoints hold the same architecture iff their rows match."""
    return sorted(f"{name} {list(value.shape)} {str(value.dtype).replace('torch.', '')}"
                  for name, value in params.state_dict().items())


def param_structure_hash(params) -> str:
    """Short stable hash of :func:`param_structure_rows`."""
    return hashlib.sha256("\n".join(param_structure_rows(params)).encode()).hexdigest()[:16]


def leaf_digest(array: np.ndarray) -> str:
    """sha256 of a leaf's dtype, shape and bytes."""
    array = np.ascontiguousarray(array)
    h = hashlib.sha256()
    h.update(str(array.dtype).encode())
    h.update(repr(tuple(array.shape)).encode())
    h.update(array.tobytes())
    return h.hexdigest()


def verify_manifest(manifest: dict, params, where: str) -> None:
    """Raise ``ValueError`` naming the differing leaves when ``params``'
    structure is not the one the checkpoint recorded, or when the schema is
    not this reader's."""
    schema = manifest.get("checkpoint_schema")
    if schema != CHECKPOINT_SCHEMA_VERSION:
        raise ValueError(f"{where} was written with checkpoint schema {schema!r}; this code "
                         f"reads schema {CHECKPOINT_SCHEMA_VERSION}")
    want, got = manifest.get("param_structure_hash"), param_structure_hash(params)
    if got != want:
        saved = set(manifest.get("param_structure_rows") or [])
        ours = set(param_structure_rows(params))
        detail = []
        if saved - ours:
            detail.append("checkpoint-only leaves: " + "; ".join(sorted(saved - ours)[:4]))
        if ours - saved:
            detail.append("template-only leaves: " + "; ".join(sorted(ours - saved)[:4]))
        raise ValueError(
            f"{where} holds a model with param structure {want} but the restore template "
            f"hashes to {got}: the architecture flags (layer widths, embedding dim, feature "
            f"dimensionalities, replicas) differ from the run that wrote it. "
            + " ".join(detail))


# ------------------------------------------------------------------- payload

def _numpy(value: torch.Tensor) -> np.ndarray:
    return value.detach().cpu().numpy()


def _pack(state, history: dict, generators, chunk_size: int | None) -> dict[str, np.ndarray]:
    leaves = {f"params/{name}": _numpy(value)
              for name, value in state.params.state_dict().items()}
    for i, slots in state.optimizer.state_dict()["state"].items():
        for slot, value in slots.items():
            if value is not None:
                leaves[f"optimizer/{i}/{slot}"] = _numpy(torch.as_tensor(value))
    leaves["schedule/last_epoch"] = np.asarray(state.schedule.last_epoch, np.int64)
    leaves["epoch"] = np.asarray(int(state.epoch), np.int64)
    for name, value in history.items():
        leaves[f"history/{name}"] = (np.asarray(value, np.int64) if name == "cursor"
                                     else _numpy(value))
    leaves["chunk_size"] = np.asarray(chunk_size or 0, np.int64)
    for r, generator in enumerate(generators):
        leaves[f"generators/{r}"] = _numpy(generator.get_state())
    return leaves


def _unpack_into(state, leaves: dict, device):
    """Load the leaves into the template ``state`` in place; returns
    (state, history, generator states)."""
    params = {name[len("params/"):]: torch.from_numpy(value)
              for name, value in leaves.items() if name.startswith("params/")}
    state.params.load_state_dict(params)
    saved = state.optimizer.state_dict()
    slots: dict[int, dict] = {}
    for name, value in leaves.items():
        if name.startswith("optimizer/"):
            _, i, slot = name.split("/")
            slots.setdefault(int(i), {})[slot] = torch.from_numpy(value)
    saved["state"] = slots
    state.optimizer.load_state_dict(saved)
    # the schedule after ``last_epoch`` updates: LambdaLR sets each group's
    # rate to base_lr * factor(last_epoch)
    count = int(leaves["schedule/last_epoch"])
    schedule = state.schedule
    rates = [base * factor(count) for base, factor in zip(schedule.base_lrs, schedule.lr_lambdas)]
    schedule_state = schedule.state_dict()
    schedule_state.update(last_epoch=count, _step_count=count + 1, _last_lr=rates)
    schedule.load_state_dict(schedule_state)
    for group, rate in zip(state.optimizer.param_groups, rates):
        group["lr"] = rate
    state.epoch = int(leaves["epoch"])
    history = {name[len("history/"):]: torch.from_numpy(value).to(device)
               for name, value in leaves.items()
               if name.startswith("history/") and name != "history/cursor"}
    history["cursor"] = int(leaves["history/cursor"])
    members = sum(name.startswith("generators/") for name in leaves)
    generators = [torch.from_numpy(leaves[f"generators/{r}"]) for r in range(members)]
    return state, history, generators


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# -------------------------------------------------------------- checkpointer

class DIBCheckpointer:
    """Checkpoint store for a ``DIBTrainer`` or a ``BetaSweepTrainer`` (its
    stacked [R, ...] leaves and R generators go through unchanged)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.restored_chunk_size: int | None = None
        self.fallback_skipped_steps: list[int] = []
        os.makedirs(self.directory, exist_ok=True)

    # ---------------------------------------------------------------- steps
    def all_steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    @property
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, history: dict, generators,
             chunk_size: int | None = None) -> str:
        """Write ``step``: the state, the history, the generators that draw
        for training (one ``torch.Generator`` or a sequence) and the chunk
        size the run is on. Returns the step's directory."""
        if isinstance(generators, torch.Generator):
            generators = [generators]
        leaves = _pack(state, history, generators, chunk_size)
        manifest = {
            "checkpoint_schema": CHECKPOINT_SCHEMA_VERSION,
            "step": int(step),
            "param_structure_hash": param_structure_hash(state.params),
            "param_structure_rows": param_structure_rows(state.params),
            "leaves": {name: leaf_digest(value) for name, value in leaves.items()},
        }
        staging = os.path.join(self.directory, f"{_STAGING}{step}-{os.getpid()}")
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        with open(os.path.join(staging, LEAVES_FILENAME), "wb") as f:
            np.savez(f, **leaves)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(staging, MANIFEST_FILENAME), "w") as f:
            json.dump(manifest, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(staging)
        final = self.step_dir(step)
        if os.path.exists(final):       # a re-save of the same step replaces it
            old = f"{staging}.old"
            os.replace(final, old)
            os.replace(staging, final)
            shutil.rmtree(old)
        else:
            os.replace(staging, final)
        _fsync_dir(self.directory)
        for stale in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(stale))
        return final

    # -------------------------------------------------------------- restore
    def _read(self, step: int) -> tuple[dict, dict]:
        """The step's manifest and leaves, digests verified."""
        path = self.step_dir(step)
        where = f"Checkpoint step {step} in {self.directory}"

        def corrupt(what: str, exc: Exception | None = None) -> CheckpointCorruptionError:
            cause = f" ({type(exc).__name__}: {exc})" if exc is not None else ""
            return CheckpointCorruptionError(
                f"{where} {what}{cause}: the step is corrupt (truncated file, flipped byte or "
                "torn write). Restore an earlier step with restore(step=...), or use "
                "restore_latest_intact() to fall back automatically.")

        if not os.path.isdir(path):
            raise FileNotFoundError(f"No checkpoint step {step} in {self.directory}")
        try:
            with open(os.path.join(path, MANIFEST_FILENAME)) as f:
                manifest = json.load(f)
            if not isinstance(manifest, dict) or not isinstance(manifest.get("leaves"), dict):
                raise ValueError("not a manifest")
        except (OSError, ValueError, UnicodeDecodeError) as exc:
            raise corrupt("has an unreadable manifest", exc) from exc
        try:
            with np.load(os.path.join(path, LEAVES_FILENAME), allow_pickle=False) as data:
                leaves = {name: data[name] for name in data.files}
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile) as exc:
            raise corrupt("failed to read back", exc) from exc
        recorded = manifest["leaves"]
        bad = sorted({name for name in recorded
                      if name not in leaves or leaf_digest(leaves[name]) != recorded[name]}
                     | (set(leaves) - set(recorded)))
        if bad:
            raise corrupt(f"failed content-digest verification on {len(bad)} leaf/leaves: "
                          f"{', '.join(bad[:4])}{' ...' if len(bad) > 4 else ''}")
        return manifest, leaves

    def restore(self, trainer, step: int | None = None, chunk_size: int | None = None):
        """Restore ``(state, history, generators)`` into ``trainer``'s model.

        ``trainer.init()`` gives the template; its model's weights are
        overwritten. ``generators`` are the saved generator states (uint8
        tensors) for ``fit``: one for a serial trainer, a list of R for a
        sweep. ``chunk_size``: the ``hook_every`` the continuation will use;
        if the checkpoint recorded one, a mismatch (or a step off the chunk
        grid) raises ``ValueError``. The recorded value is also
        ``self.restored_chunk_size``.
        """
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        where = f"Checkpoint step {step} in {self.directory}"
        template, _ = trainer.init()
        manifest, leaves = self._read(step)
        verify_manifest(manifest, template.params, where)
        saved_chunk = int(leaves["chunk_size"])
        self.restored_chunk_size = saved_chunk or None
        if chunk_size is not None and saved_chunk:
            if saved_chunk != chunk_size:
                raise ValueError(
                    f"{where} was written with chunk size (hook_every) {saved_chunk} but the "
                    f"continuation requests {chunk_size}: hooks would run at other epochs, "
                    f"so this would not continue the same run. Resume with "
                    f"hook_every={saved_chunk}.")
            epoch = int(leaves["epoch"])
            if epoch % saved_chunk:
                raise ValueError(
                    f"{where} at epoch {epoch} is not on the chunk grid (chunk size "
                    f"{saved_chunk}): it was saved after a partial final chunk. Restore an "
                    f"aligned step with restore(step=...), or omit chunk_size to extend this "
                    f"finished run on a fresh chunk grid.")
        state, history, generators = _unpack_into(template, leaves, trainer.device)
        return state, history, (generators if hasattr(trainer, "num_replicas")
                                else generators[0])

    def quarantine_step(self, step: int, reason: str) -> str:
        """Move a step into ``quarantine/`` (never delete it), with a
        ``QUARANTINE.json`` naming the reason; returns its new path."""
        root = os.path.join(self.directory, QUARANTINE_DIRNAME)
        os.makedirs(root, exist_ok=True)
        dst, n = os.path.join(root, str(step)), 1
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(root, f"{step}-{n}")
        os.replace(self.step_dir(step), dst)
        with open(os.path.join(dst, "QUARANTINE.json"), "w") as f:
            json.dump({"step": int(step), "reason": reason, "directory": self.directory}, f,
                      indent=1)
            f.write("\n")
        return dst

    def restore_latest_intact(self, trainer, chunk_size: int | None = None, on_fallback=None):
        """Restore the newest step that reads back intact. Corrupt steps
        (``CheckpointCorruptionError`` only: a template or chunk-contract
        ``ValueError`` is wrong at every step and propagates) are walked
        newest to oldest, each moved into ``quarantine/`` and reported to
        ``on_fallback({"step", "error", "quarantined"})``; the skipped steps
        are in ``self.fallback_skipped_steps``. Raises when every step is
        corrupt."""
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        self.fallback_skipped_steps = []
        last_exc = None
        for step in steps:
            try:
                return self.restore(trainer, step=step, chunk_size=chunk_size)
            except CheckpointCorruptionError as exc:
                last_exc = exc
                self.fallback_skipped_steps.append(step)
                info = {"step": step, "error": str(exc),
                        "quarantined": self.quarantine_step(step, f"corrupt at restore: {exc}")}
                if on_fallback is not None:
                    on_fallback(info)
        raise CheckpointCorruptionError(
            f"All {len(steps)} checkpoint step(s) in {self.directory} are corrupt; last "
            f"error: {last_exc}") from last_exc


class CheckpointHook:
    """Saves a checkpoint at every call (compose with ``Every`` for a
    cadence), from what ``fit`` publishes on the trainer before its hooks
    run: ``resume_generators``, ``latest_history`` and ``resume_chunk``."""

    def __init__(self, checkpointer: DIBCheckpointer):
        self.checkpointer = checkpointer

    def __call__(self, trainer, state, epoch: int) -> None:
        generators = getattr(trainer, "resume_generators", None)
        history = getattr(trainer, "latest_history", None)
        if generators is None or history is None:
            raise RuntimeError(
                "CheckpointHook needs trainer.resume_generators and trainer.latest_history: "
                "run it through fit(hooks=[...]) with draws from torch generators")
        self.checkpointer.save(epoch, state, history, generators,
                               chunk_size=getattr(trainer, "resume_chunk", None))


def iter_hooks(hooks):
    """Every hook of a fit's hook list, with those nested inside adapters:
    ``Every`` and ``SpannedHook`` (``.hook``), hook combinations and
    per-replica adapters (``.hooks``), in breadth-first order."""
    pending = list(hooks)
    while pending:
        hook = pending.pop(0)
        yield hook
        inner = getattr(hook, "__dict__", {}).get("hook")
        if inner is not None:
            pending.append(inner)
        pending.extend(getattr(hook, "hooks", ()) or ())


def find_checkpointer(hooks) -> DIBCheckpointer | None:
    """The checkpointer in a fit's hook list (or a proxy of one, such as
    ``PoisonedReplicaRestore``), looking inside adapters."""
    for hook in iter_hooks(hooks):
        ckpt = getattr(hook, "__dict__", {}).get("checkpointer")
        if ckpt is not None and hasattr(ckpt, "restore_latest_intact") \
                and hasattr(ckpt, "latest_step"):
            return ckpt
    return None


def fallback_reporter(telemetry, *, source: str, log=None):
    """The ``on_fallback`` of every ``restore_latest_intact`` caller (the
    CLI's resume, the divergence rollback, the sweep's quarantine): a
    corrupt step skipped on the way is a ``checkpoint_fallback``
    mitigation, its quarantine a ``quarantine`` event, and one line through
    ``log`` (default ``warnings.warn``). ``telemetry`` may be None."""
    def report(info: dict) -> None:
        import warnings

        msg = (f"{source}: checkpoint step {info['step']} is corrupt and was skipped "
               f"(quarantined={info.get('quarantined')}): {info['error']}")
        (log if log is not None else warnings.warn)(msg)
        if telemetry is None:
            return
        telemetry.mitigation(mtype="checkpoint_fallback", **info)
        if info.get("quarantined"):
            telemetry.quarantine(step=info["step"], reason="corrupt at restore",
                                 path=info["quarantined"], source=source, error=info["error"])

    return report
