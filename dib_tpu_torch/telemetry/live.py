"""Following a growing events.jsonl (counterpart of
``dib_tpu/telemetry/live.py``).

Only :class:`StreamFollower` is ported: the watchdog reads its workers'
heartbeats through it. ``tail`` and the dashboard wait for ROADMAP.md
queue 1, item 6. Host-side file reading only.
"""

from __future__ import annotations

import json
import os

from dib_tpu_torch.telemetry.events import resolve_events_path

__all__ = ["StreamFollower"]


class StreamFollower:
    """Incremental reader over a (possibly still growing) events.jsonl.

    ``poll()`` returns the complete events appended since the last call.
    The bytes after the last newline are an append in progress and stay
    buffered; a complete line that does not parse (a writer killed
    mid-append) is skipped and counted in ``torn``. A file that does not
    exist yet polls empty; one that shrank is read again from the top.
    """

    def __init__(self, path: str):
        self._given = path        # resolved at each poll: the run dir may not exist yet
        self._offset = 0
        self._buf = b""
        self.torn = 0
        self.events_read = 0

    @property
    def path(self) -> str:
        return resolve_events_path(self._given)

    def poll(self) -> list[dict]:
        try:
            size = os.stat(self.path).st_size
        except OSError:
            return []
        if size < self._offset:
            self._offset = 0
            self._buf = b""
        if size == self._offset and not self._buf:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        self._offset += len(data)
        lines = (self._buf + data).split(b"\n")
        self._buf = lines.pop()
        out = []
        for line in lines:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                self.torn += 1
        self.events_read += len(out)
        return out
