"""Cross-process trace context (counterpart of
``dib_tpu/telemetry/context.py``).

A :class:`TraceContext` names a causal lineage: ``trace_id`` is minted once
at the root, ``parent`` names the record that caused this one
(``plane:record_ref``, e.g. ``run:<run_id>``), and ``origin`` is the chain
of entry points the context passed through. It rides as the ``ctx``
envelope field of every event a traced :class:`~dib_tpu_torch.telemetry.
events.EventWriter` writes. Spawned processes (watchdog relaunches)
inherit it through the environment, as the JAX package's do:
``DIB_TRACE_ID``, ``DIB_TRACE_PARENT`` and ``DIB_TRACE_ORIGIN``.
"""

from __future__ import annotations

import dataclasses
import os
import uuid

__all__ = ["TRACE_ENV", "TRACE_ORIGIN_ENV", "TRACE_PARENT_ENV", "TraceContext",
           "child_context", "ensure_context", "from_env", "mint"]

TRACE_ENV = "DIB_TRACE_ID"
TRACE_PARENT_ENV = "DIB_TRACE_PARENT"
TRACE_ORIGIN_ENV = "DIB_TRACE_ORIGIN"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One causal lineage: ``trace_id`` (shared by everything the root
    caused), ``parent`` (the immediate cause, None at the root) and
    ``origin`` (the entry points passed through, in order)."""

    trace_id: str
    parent: str | None = None
    origin: tuple[str, ...] = ()

    def to_dict(self) -> dict:
        out: dict = {"trace_id": self.trace_id}
        if self.parent:
            out["parent"] = self.parent
        if self.origin:
            out["origin"] = list(self.origin)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TraceContext | None":
        if not isinstance(d, dict) or not d.get("trace_id"):
            return None
        origin = d.get("origin") or ()
        if not isinstance(origin, (list, tuple)):
            origin = ()
        return cls(trace_id=str(d["trace_id"]),
                   parent=str(d["parent"]) if d.get("parent") else None,
                   origin=tuple(str(o) for o in origin))

    def child(self, parent_ref: str, origin: str | None = None) -> "TraceContext":
        """The context of a record caused by ``parent_ref``: the same
        trace id, a new parent, the origin chain extended by a new entry
        point."""
        chain = self.origin
        if origin and (not chain or chain[-1] != origin):
            chain = chain + (origin,)
        return TraceContext(self.trace_id, parent=parent_ref, origin=chain)

    def activate(self, environ=None) -> None:
        """Export to the environment, so spawned processes inherit it."""
        env = os.environ if environ is None else environ
        env[TRACE_ENV] = self.trace_id
        if self.parent:
            env[TRACE_PARENT_ENV] = self.parent
        else:
            env.pop(TRACE_PARENT_ENV, None)
        if self.origin:
            env[TRACE_ORIGIN_ENV] = ",".join(self.origin)
        else:
            env.pop(TRACE_ORIGIN_ENV, None)


def mint(origin: str, trace_id: str | None = None, parent: str | None = None) -> TraceContext:
    """A fresh context at a causal root; ``trace_id`` overrides the
    generated id."""
    return TraceContext(trace_id or ("trace-" + uuid.uuid4().hex[:12]), parent=parent,
                        origin=(origin,))


def from_env(environ=None) -> TraceContext | None:
    """The lineage a parent process pinned (None when unpinned)."""
    env = os.environ if environ is None else environ
    trace_id = env.get(TRACE_ENV)
    if not trace_id:
        return None
    origin = tuple(o for o in (env.get(TRACE_ORIGIN_ENV) or "").split(",") if o)
    return TraceContext(trace_id, parent=env.get(TRACE_PARENT_ENV) or None, origin=origin)


def ensure_context(origin: str, trace_id: str | None = None) -> TraceContext:
    """An explicit ``trace_id`` wins, then an inherited lineage (extended
    with this entry point), else a fresh root."""
    inherited = from_env()
    if trace_id and (inherited is None or inherited.trace_id != trace_id):
        return mint(origin, trace_id=trace_id)
    if inherited is None:
        return mint(origin)
    if inherited.origin and inherited.origin[-1] == origin:
        return inherited
    return dataclasses.replace(inherited, origin=inherited.origin + (origin,))


def child_context(ctx: "TraceContext | None", parent_ref: str,
                  origin: str | None = None) -> TraceContext | None:
    """``ctx.child(...)``, or None for an untraced caller."""
    if ctx is None:
        return None
    return ctx.child(parent_ref, origin=origin)

