"""Prefork socket request plane: N server processes, one port
(counterpart of ``dib_tpu/serve/prefork.py``).

``serve/pool.py`` moves the ENGINE out of the parent process (the pipe
request plane), the right cut when model dispatch dominates. When the
HTTP side dominates (parsing, JSON, response serialization on the event
loop, all under one GIL however many replica threads sit behind it), the
prefork plane cuts there instead: N full server processes (each its own
event loop, batchers, engine and GIL) bind the SAME port with
``SO_REUSEPORT`` and the KERNEL balances accepted connections across them.

The supervisor is deliberately thin: spawn the workers (each a real
``python -m dib_tpu_torch serve`` invocation with ``--reuse_port``),
aggregate their hello lines into one machine-readable line, respawn workers
that die unexpectedly (a budgeted, logged loop: a crashed worker's
in-flight connections reset, new connections route to the survivors,
capacity heals on respawn), and forward SIGTERM for a graceful fleet
shutdown. Each worker gets its own ``--outdir`` (``<outdir>/worker<K>``),
and so its own event stream (``<outdir>/worker<K>/events.jsonl``):
interleaving processes onto one events.jsonl would collide their seq
chains. The caller pins the fleet's trace context in the environment
(``ensure_context("serve").activate()``), so every worker's stream carries
one ``trace_id``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["WORKER_COMMAND", "reserve_port", "strip_flag", "supervise_prefork"]

_RESPAWN_BUDGET = 10
#: what each worker runs, before the serve flags
WORKER_COMMAND = (sys.executable, "-m", "dib_tpu_torch", "serve")


def reserve_port(host: str) -> tuple[socket.socket, int]:
    """A bound-but-NOT-listening ``SO_REUSEPORT`` socket: it pins a free
    port number for the worker fleet without receiving any connections
    (the kernel only balances across LISTENING reuseport sockets)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, 0))
    return sock, sock.getsockname()[1]


def strip_flag(argv: list[str], flag: str, has_value: bool) -> list[str]:
    """Remove every spelling of ``flag`` — ``--f v``, ``--f=v``, AND
    argparse's unambiguous-prefix abbreviations (``--prefor 3``) — from
    an argv COPY, positionally. Both halves are load-bearing lessons:
    value-equality filtering would eat argument values that happen to
    spell the flag, and missing the abbreviated spellings would let
    ``--prefor N`` survive into the worker re-exec, turning every worker
    into a supervisor of N more workers — a fork bomb. A prefix that parsed successfully can only
    have resolved to THIS flag (argparse rejects ambiguous prefixes
    before we run), so matching any ``--``-prefixed prefix of ``flag``
    is safe."""
    out: list[str] = []
    skip = False
    for token in argv:
        if skip:
            skip = False
            continue
        name, sep, _ = token.partition("=")
        is_this_flag = (name.startswith("--") and len(name) > 2
                        and flag.startswith(name))
        if is_this_flag:
            skip = has_value and not sep
            continue
        out.append(token)
    return out


def supervise_prefork(argv: list[str], *, prefork: int, host: str,
                      port: int, outdir: str,
                      serve_seconds: float = 0.0,
                      command=WORKER_COMMAND) -> int:
    """Run ``prefork`` serve workers on one shared port and supervise.

    ``argv`` is the original ``dib_tpu_torch serve`` argv; each worker runs
    ``command`` (``python -m dib_tpu_torch serve``) with it, ``--prefork``
    stripped and ``--port``/``--reuse_port``/``--outdir`` overridden.
    Returns the supervisor's exit code.
    """
    if prefork < 1:
        raise ValueError(f"prefork must be >= 1, got {prefork}")
    reserve = None
    if port == 0:
        reserve, port = reserve_port(host)
    base = strip_flag(argv, "--prefork", True)
    for flag in ("--port", "--outdir"):
        base = strip_flag(base, flag, True)
    base = strip_flag(base, "--reuse_port", False)

    def worker_cmd(k: int) -> list[str]:
        return [*command, *base,
                "--port", str(port), "--reuse_port",
                "--outdir", os.path.join(outdir, f"worker{k}")]

    def spawn(k: int) -> subprocess.Popen:
        return subprocess.Popen(worker_cmd(k), stdout=subprocess.PIPE,
                                text=True)

    workers: list[subprocess.Popen] = []
    hellos: list[dict] = []
    handlers: dict = {}
    try:
        workers = [spawn(k) for k in range(prefork)]
        for proc in workers:
            line = proc.stdout.readline()
            try:
                hellos.append(json.loads(line))
            except ValueError:
                raise RuntimeError(
                    f"prefork worker never announced readiness: {line!r}")
        print(json.dumps({
            "serving": f"http://{host}:{port}", "port": port,
            "prefork": prefork, "run_dir": outdir,
            "workers": [p.pid for p in workers],
            "models": hellos[0].get("models"),
            "replicas_per_worker": hellos[0].get("replicas"),
        }), flush=True)

        stop = threading.Event()
        if threading.current_thread() is threading.main_thread():
            for signum in (signal.SIGINT, signal.SIGTERM):
                handlers[signum] = signal.signal(signum, lambda *_: stop.set())
        deadline = (time.monotonic() + serve_seconds + 30.0
                    if serve_seconds > 0 else None)
        respawns = 0
        while not stop.is_set():
            stop.wait(0.5)
            if deadline is not None and time.monotonic() > deadline:
                break
            if serve_seconds > 0 and all(
                    p.poll() is not None for p in workers):
                break   # every worker finished its own --serve_seconds
            for k, proc in enumerate(workers):
                rc = proc.poll()
                if rc is None or (serve_seconds > 0 and rc == 0):
                    continue
                # unexpected death: connections on this worker reset,
                # the kernel routes new ones to survivors; respawn to
                # heal capacity — budgeted so a crash loop cannot spin
                if respawns >= _RESPAWN_BUDGET:
                    print(f"prefork: worker {k} died (rc {rc}) and the "
                          f"respawn budget ({_RESPAWN_BUDGET}) is spent",
                          file=sys.stderr, flush=True)
                    stop.set()
                    break
                respawns += 1
                print(f"prefork: worker {k} died (rc {rc}); respawning "
                      f"({respawns}/{_RESPAWN_BUDGET})",
                      file=sys.stderr, flush=True)
                workers[k] = spawn(k)
                workers[k].stdout.readline()   # wait for readiness
    finally:
        for proc in workers:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in workers:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
        if reserve is not None:
            reserve.close()
        for signum, handler in handlers.items():
            signal.signal(signum, handler)
    return 0
