"""Live fleet dashboard over the serving ``/metrics`` plane
(counterpart of ``dib_tpu/serve/top.py``).

``python -m dib_tpu_torch serve top --url http://HOST:PORT --workers N``
attaches to a RUNNING serving fleet (single process or SO_REUSEPORT
prefork) and renders a refreshing plain-text dashboard (``--once`` /
``--no_ansi`` for scripts and tests):

  - one row per worker process: pid, req/s (counter deltas between
    frames), response-cache hit fraction, quota/shed rejections;
  - fleet-merged END-TO-END and PER-PHASE p50/p99, computed from the
    native histogram buckets (``le_*`` keys) summed across workers, which
    is exact because every worker buckets against the same fleet-wide
    ``BUCKET_BOUNDS`` (``telemetry/metrics.py``).

Scraping: each fresh ``/metrics`` connection lands on ONE worker (the kernel
balances accepted connections across the prefork fleet), so every frame
scrapes on fresh connections until ``--workers`` distinct pids answered,
bounded. A worker the kernel never routes to goes unsampled that frame and
its last-seen snapshot is kept.

Everything here is host-side HTTP (urllib) and arithmetic: this module
imports no torch, so ``serve top`` starts instantly next to a running
fleet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from dib_tpu_torch.telemetry import REQUEST_PHASES
from dib_tpu_torch.telemetry.metrics import bucket_counts, bucket_quantile

__all__ = ["FleetState", "render_top", "serve_top_main", "top"]

_E2E_HIST = "serve.request_latency_s"


def _get_json(url: str, timeout_s: float = 2.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def scrape_fleet(url: str, workers: int,
                 timeout_s: float = 2.0) -> dict[int, dict]:
    """One frame's scrape: pid -> /metrics snapshot, repeating on fresh
    connections until ``workers`` distinct pids answered (bounded
    attempts). Partial fleets return partially — honestly."""
    by_pid: dict[int, dict] = {}
    attempts = max(int(workers) * 6, 1)
    for _ in range(attempts):
        try:
            snapshot = _get_json(url.rstrip("/") + "/metrics", timeout_s)
        except Exception:
            break
        by_pid[int(snapshot.get("pid", 0))] = snapshot
        if len(by_pid) >= workers:
            break
    return by_pid


def merged_buckets(by_pid: dict[int, dict], name: str) -> list:
    """Dense fleet bucket counts for histogram ``name``: per-worker
    sparse ``le_*`` keys re-densified and summed index-wise."""
    total: list = []
    for snap in by_pid.values():
        hist = (snap.get("histograms") or {}).get(name)
        if not isinstance(hist, dict):
            continue
        dense = bucket_counts(hist)
        if not total:
            total = dense
        else:
            total = [a + b for a, b in zip(total, dense)]
    return total


def _hist_stat(by_pid: dict[int, dict], name: str, stat: str) -> float:
    return float(sum(
        (snap.get("histograms") or {}).get(name, {}).get(stat, 0) or 0
        for snap in by_pid.values()))


def _counter(snap: dict, name: str) -> float:
    return float((snap.get("counters") or {}).get(name, 0) or 0)


def _requests_total(snap: dict) -> float:
    return sum(value for key, value in (snap.get("counters") or {}).items()
               if key.startswith("serve.requests."))


class FleetState:
    """Scrape accumulator across frames: remembers each pid's last
    snapshot (an unsampled worker keeps its previous one) and the
    previous frame's totals for per-worker req/s deltas."""

    def __init__(self, url: str, workers: int):
        self.url = url
        self.workers = int(workers)
        self.by_pid: dict[int, dict] = {}
        self._prev: dict[int, tuple[float, float]] = {}   # pid -> (t, reqs)
        self.rates: dict[int, float | None] = {}
        self.frames = 0

    def poll(self) -> bool:
        """Scrape one frame; returns True when at least one worker
        answered (ever — a dead fleet keeps rendering its last state)."""
        now = time.perf_counter()
        fresh = scrape_fleet(self.url, self.workers)
        self.by_pid.update(fresh)
        for pid, snap in fresh.items():
            total = _requests_total(snap)
            prev = self._prev.get(pid)
            if prev is not None and now > prev[0]:
                self.rates[pid] = max(total - prev[1], 0.0) \
                    / (now - prev[0])
            else:
                self.rates.setdefault(pid, None)
            self._prev[pid] = (now, total)
        self.frames += 1
        return bool(self.by_pid)


def _fmt_ms(seconds: float | None) -> str:
    return "-" if seconds is None else f"{seconds * 1e3:9.3f}"


def render_top(state: FleetState, width: int = 100) -> str:
    """One plain-text frame: fleet header, merged end-to-end + per-phase
    quantiles, one row per worker."""
    by_pid = state.by_pid
    lines = [
        f"dib_tpu_torch serve top — {state.url} — "
        f"{len(by_pid)}/{state.workers} worker(s) seen "
        f"(frame {state.frames})"
    ]
    if not by_pid:
        lines.append("  no /metrics sample yet — is the fleet up?")
        return "\n".join(lines)
    e2e = merged_buckets(by_pid, _E2E_HIST)
    n = int(sum(e2e)) if e2e else 0
    lines.append(
        f"fleet end-to-end   p50 {_fmt_ms(bucket_quantile(e2e, 0.5) if e2e else None)} ms"
        f"   p99 {_fmt_ms(bucket_quantile(e2e, 0.99) if e2e else None)} ms"
        f"   n={n}")
    lines.append(f"  {'phase':<10} {'p50 ms':>9} {'p99 ms':>9} "
                 f"{'count':>8} {'share%':>7}")
    total_time = sum(
        _hist_stat(by_pid, f"serve.phase.{p}", "sum")
        for p in REQUEST_PHASES) or None
    for phase in REQUEST_PHASES:
        dense = merged_buckets(by_pid, f"serve.phase.{phase}")
        count = int(sum(dense)) if dense else 0
        phase_sum = _hist_stat(by_pid, f"serve.phase.{phase}", "sum")
        share = (100.0 * phase_sum / total_time) if total_time else 0.0
        lines.append(
            f"  {phase:<10} {_fmt_ms(bucket_quantile(dense, 0.5) if dense else None):>9}"
            f" {_fmt_ms(bucket_quantile(dense, 0.99) if dense else None):>9}"
            f" {count:>8} {share:>6.1f}%")
    lines.append(f"  {'pid':<8} {'req/s':>8} {'cache-hit':>9} "
                 f"{'quota':>7} {'shed':>6} {'ok':>8}")
    for pid in sorted(by_pid):
        snap = by_pid[pid]
        hits = _counter(snap, "serve.cache.response.hits")
        misses = _counter(snap, "serve.cache.response.misses")
        hit_frac = hits / (hits + misses) if hits + misses else 0.0
        rate = state.rates.get(pid)
        lines.append(
            f"  {pid:<8} {('-' if rate is None else f'{rate:8.1f}'):>8}"
            f" {hit_frac:>8.2f} "
            f" {int(_counter(snap, 'serve.requests.quota')):>7}"
            f" {int(_counter(snap, 'serve.requests.shed')):>6}"
            f" {int(_counter(snap, 'serve.requests.ok')):>8}")
    return "\n".join(line[:width] for line in lines)


def top(url: str, *, workers: int = 1, refresh_s: float = 1.0,
        duration_s: float | None = None, max_frames: int | None = None,
        out=None, ansi: bool | None = None) -> FleetState:
    """Follow a serving fleet's /metrics, rendering a refreshing
    dashboard until ``duration_s`` / ``max_frames`` (or forever).
    Returns the final :class:`FleetState`."""
    out = sys.stdout if out is None else out
    if ansi is None:
        ansi = hasattr(out, "isatty") and out.isatty()
    state = FleetState(url, workers)
    deadline = (time.time() + duration_s) if duration_s else None
    while True:
        state.poll()
        frame = render_top(state)
        if ansi:
            out.write("\x1b[2J\x1b[H" + frame + "\n")
        else:
            out.write(frame + "\n\n")
        out.flush()
        if max_frames is not None and state.frames >= max_frames:
            break
        if deadline is not None and time.time() >= deadline:
            break
        time.sleep(refresh_s)
    return state


def serve_top_main(argv) -> int:
    """``python -m dib_tpu_torch serve top``: live fleet dashboard."""
    parser = argparse.ArgumentParser(
        prog="dib_tpu_torch serve top",
        description="Live serving-fleet dashboard: per-worker req/s and "
                    "cache/quota counters plus fleet-merged end-to-end "
                    "and per-phase latency quantiles from the native "
                    "histogram buckets on /metrics.")
    parser.add_argument("--url", type=str, required=True,
                        help="Base URL of the serving fleet "
                             "(http://HOST:PORT).")
    parser.add_argument("--workers", type=int, default=1,
                        help="Expected worker-process count (prefork N); "
                             "each frame scrapes until this many distinct "
                             "pids answered.")
    parser.add_argument("--refresh_s", type=float, default=1.0,
                        help="Seconds between frames.")
    parser.add_argument("--duration_s", type=float, default=0.0,
                        help="Stop after this many seconds (0 = forever).")
    parser.add_argument("--frames", type=int, default=0,
                        help="Stop after this many frames (0 = unbounded).")
    parser.add_argument("--once", action="store_true",
                        help="Render exactly one frame and exit "
                             "(implies --no_ansi).")
    parser.add_argument("--no_ansi", action="store_true",
                        help="Plain appended frames (no clear-screen).")
    args = parser.parse_args(argv)
    state = top(
        args.url,
        workers=args.workers,
        refresh_s=args.refresh_s,
        duration_s=args.duration_s or None,
        max_frames=1 if args.once else (args.frames or None),
        ansi=False if (args.once or args.no_ansi) else None,
    )
    return 0 if state.by_pid else 1
