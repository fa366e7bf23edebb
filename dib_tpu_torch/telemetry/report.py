"""Self-contained static HTML run reports from an events.jsonl
(counterpart of ``dib_tpu/telemetry/report.py``).

``python -m dib_tpu_torch telemetry report <run-dir>`` renders ONE html file with
zero external resources (inline CSS + SVG; light/dark via
``prefers-color-scheme``), so a run report can be attached to an issue or
kept next to the run artifacts forever:

  - header: provenance stat tiles (device, status, wall-clock, steps/s);
  - span breakdown: the trace hierarchy (``telemetry/trace.py``) as a
    flame-style indented bar list, by total time per normalized path;
  - training trajectory: per-chunk steps/s, loss/val-loss, and total KL
    line charts from ``chunk`` events;
  - MI sandwich: mean lower/upper bound trajectory with the gap shaded;
  - memory: device + host high-water marks;
  - utilization: the JAX package's per-compiled-callable roofline table
    needs ``compile`` events and a TPU peak table; the port's summary has
    neither (``telemetry/summary.py``), so the section says so.

All computation is host-side file analysis: no matplotlib and no torch, so
a report renders on the card's machine too.
"""

from __future__ import annotations

import html
import json
import math
import os

from dib_tpu_torch.telemetry.events import read_events, resolve_events_path
from dib_tpu_torch.telemetry.summary import summarize

__all__ = ["render_index", "render_report", "write_index", "write_report"]


# Validated default palette (dataviz reference instance): categorical slots
# 1-3 stepped per mode, text/surface tokens, recessive grid.
_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px; font: 14px/1.5 system-ui, sans-serif;
  background: var(--surface-1); color: var(--text-primary);
  --surface-1: #fcfcfb; --surface-2: #f1f0ee;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e4e3e0; --series-1: #2a78d6; --series-2: #eb6834;
  --series-3: #1baf7a; --band: rgba(42, 120, 214, 0.14);
}
@media (prefers-color-scheme: dark) {
  body {
    --surface-1: #1a1a19; --surface-2: #242423;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #343432; --series-1: #3987e5; --series-2: #d95926;
    --series-3: #199e70; --band: rgba(57, 135, 229, 0.22);
  }
}
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 15px; margin: 28px 0 8px; }
.sub { color: var(--text-secondary); margin: 0 0 16px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin: 16px 0; }
.tile { background: var(--surface-2); border-radius: 8px;
        padding: 10px 14px; min-width: 120px; }
.tile .v { font-size: 18px; font-weight: 600; }
.tile .k { color: var(--text-secondary); font-size: 12px; }
.spans { margin: 8px 0; max-width: 860px; }
.span-row { display: flex; align-items: center; gap: 8px;
            margin: 2px 0; font-size: 13px; }
.span-name { flex: 0 0 340px; white-space: nowrap; overflow: hidden;
             text-overflow: ellipsis; font-family: ui-monospace, monospace; }
.span-bar-rail { flex: 1; background: var(--surface-2); border-radius: 4px;
                 height: 14px; position: relative; }
.span-bar { position: absolute; top: 0; bottom: 0; border-radius: 4px;
            background: var(--series-1); min-width: 2px; }
.span-secs { flex: 0 0 150px; color: var(--text-secondary);
             font-size: 12px; text-align: right; }
table { border-collapse: collapse; font-size: 13px; }
th, td { text-align: right; padding: 4px 10px;
         border-bottom: 1px solid var(--grid); }
th:first-child, td:first-child { text-align: left;
                                 font-family: ui-monospace, monospace; }
th { color: var(--text-secondary); font-weight: 500; }
svg text { fill: var(--text-secondary); font: 11px system-ui, sans-serif; }
svg .gridline { stroke: var(--grid); stroke-width: 1; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
.legend { display: flex; gap: 16px; font-size: 12px;
          color: var(--text-secondary); margin: 2px 0 0 44px; }
.legend .swatch { display: inline-block; width: 10px; height: 10px;
                  border-radius: 2px; margin-right: 5px;
                  vertical-align: -1px; }
.note { color: var(--text-secondary); font-size: 13px; }
details { margin: 24px 0; }
details pre { background: var(--surface-2); padding: 12px;
              border-radius: 8px; overflow-x: auto; font-size: 12px; }
.charts { display: flex; flex-wrap: wrap; gap: 24px; }
.chart h3 { font-size: 13px; margin: 0 0 2px;
            color: var(--text-primary); font-weight: 600; }
"""


def _esc(x) -> str:
    return html.escape(str(x))


def _fmt_seconds(s: float) -> str:
    if s >= 120:
        return f"{s / 60:.1f} min"
    if s >= 1:
        return f"{s:.2f} s"
    return f"{s * 1e3:.1f} ms"


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024 or unit == "TiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b:.0f} B"
        b /= 1024
    return f"{b:.1f} TiB"


def _finite_points(points):
    return [(x, y) for x, y in points
            if isinstance(y, (int, float)) and math.isfinite(y)]


def _ticks(lo: float, hi: float, n: int = 4) -> list[float]:
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(raw)) if raw > 0 else 1.0
    step = next((m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw),
                raw)
    start = math.ceil(lo / step) * step
    out = []
    t = start
    while t <= hi + 1e-12 * abs(hi):
        out.append(round(t, 10))
        t += step
    return out or [lo, hi]


def _fmt_tick(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 10000 or abs(v) < 0.01:
        return f"{v:.1e}"
    return f"{v:g}"


class _Scale:
    def __init__(self, points_lists, width, height, pad_l=44, pad_r=12,
                 pad_t=8, pad_b=20):
        xs = [p[0] for pts in points_lists for p in pts]
        ys = [p[1] for pts in points_lists for p in pts]
        self.x0, self.x1 = (min(xs), max(xs)) if xs else (0.0, 1.0)
        self.y0, self.y1 = (min(ys), max(ys)) if ys else (0.0, 1.0)
        if self.x1 <= self.x0:
            self.x1 = self.x0 + 1.0
        if self.y1 <= self.y0:
            self.y0, self.y1 = self.y0 - 0.5, self.y1 + 0.5
        else:  # headroom so lines don't kiss the frame
            span = self.y1 - self.y0
            self.y0 -= 0.05 * span
            self.y1 += 0.05 * span
        self.pl, self.pr, self.pt, self.pb = pad_l, pad_r, pad_t, pad_b
        self.w, self.h = width, height

    def x(self, v) -> float:
        return self.pl + (v - self.x0) / (self.x1 - self.x0) * (
            self.w - self.pl - self.pr)

    def y(self, v) -> float:
        return self.pt + (self.y1 - v) / (self.y1 - self.y0) * (
            self.h - self.pt - self.pb)


def _line_chart(title: str, series, *, width=420, height=150,
                x_label="epoch", band_pair=None) -> str:
    """One SVG line chart. ``series``: [(name, css_color_var, points)].
    ``band_pair``: (i, j) series indices to shade between (MI sandwich).
    Multi-series charts get a legend; every point carries a native hover
    tooltip (<title>)."""
    series = [(name, color, _finite_points(pts)) for name, color, pts in series]
    series = [s for s in series if s[2]]
    if not series:
        return ""
    sc = _Scale([pts for _, _, pts in series], width, height)
    parts = [f'<svg viewBox="0 0 {width} {height}" width="{width}" '
             f'height="{height}" role="img" aria-label="{_esc(title)}">']
    for t in _ticks(sc.y0, sc.y1):
        if not (sc.y0 <= t <= sc.y1):
            continue
        y = sc.y(t)
        parts.append(f'<line class="gridline" x1="{sc.pl}" y1="{y:.1f}" '
                     f'x2="{width - sc.pr}" y2="{y:.1f}"/>')
        parts.append(f'<text x="{sc.pl - 6}" y="{y + 3.5:.1f}" '
                     f'text-anchor="end">{_fmt_tick(t)}</text>')
    parts.append(f'<line class="axis" x1="{sc.pl}" y1="{height - sc.pb}" '
                 f'x2="{width - sc.pr}" y2="{height - sc.pb}"/>')
    for t in _ticks(sc.x0, sc.x1, 5):
        if not (sc.x0 <= t <= sc.x1):
            continue
        parts.append(f'<text x="{sc.x(t):.1f}" y="{height - 6}" '
                     f'text-anchor="middle">{_fmt_tick(t)}</text>')
    parts.append(f'<text x="{width - sc.pr}" y="{height - 6}" '
                 f'text-anchor="end">{_esc(x_label)}</text>')
    if band_pair is not None and len(series) > max(band_pair):
        lo = series[band_pair[0]][2]
        hi = series[band_pair[1]][2]
        if len(lo) == len(hi):
            pts = ([f"{sc.x(x):.1f},{sc.y(y):.1f}" for x, y in hi]
                   + [f"{sc.x(x):.1f},{sc.y(y):.1f}" for x, y in lo[::-1]])
            parts.append(f'<polygon points="{" ".join(pts)}" '
                         f'fill="var(--band)" stroke="none"/>')
    for name, color, pts in series:
        d = " ".join(f"{sc.x(x):.1f},{sc.y(y):.1f}" for x, y in pts)
        parts.append(f'<polyline points="{d}" fill="none" '
                     f'stroke="var({color})" stroke-width="2" '
                     f'stroke-linejoin="round"/>')
        for x, y in pts:
            parts.append(
                f'<circle cx="{sc.x(x):.1f}" cy="{sc.y(y):.1f}" r="2.5" '
                f'fill="var({color})"><title>{_esc(name)} @ '
                f'{_fmt_tick(x)}: {y:.5g}</title></circle>')
    parts.append("</svg>")
    legend = ""
    if len(series) > 1:
        legend = '<div class="legend">' + "".join(
            f'<span><span class="swatch" style="background:var({color})">'
            f'</span>{_esc(name)}</span>'
            for name, color, _ in series
        ) + "</div>"
    return (f'<div class="chart"><h3>{_esc(title)}</h3>'
            f"{''.join(parts)}{legend}</div>")


def _tiles(pairs) -> str:
    cells = "".join(
        f'<div class="tile"><div class="v">{_esc(v)}</div>'
        f'<div class="k">{_esc(k)}</div></div>'
        for k, v in pairs if v is not None
    )
    return f'<div class="tiles">{cells}</div>'


def _span_section(summary: dict) -> str:
    rollup = summary.get("spans") or {}
    if not rollup:
        return ('<p class="note">No span events in this stream — run with '
                "telemetry enabled on a spans-wired entry point "
                "(train/sweep/boolean/northstar) to get the trace "
                "breakdown.</p>")
    # Tree by NEAREST PRESENT ancestor: a span recorded with a slash name
    # and no enclosing spans ("sweep/replica*/mi_bounds" with no "sweep"
    # entry) roots the subtree itself instead of silently vanishing.
    children: dict[str, list[str]] = {}
    for path in rollup:
        parts = path.split("/")
        ancestor = ""
        for i in range(len(parts) - 1, 0, -1):
            candidate = "/".join(parts[:i])
            if candidate in rollup:
                ancestor = candidate
                break
        children.setdefault(ancestor, []).append(path)
    roots = children.get("", [])
    top_total = sum(rollup[p]["total_s"] for p in roots) or max(
        (s["total_s"] for s in rollup.values()), default=1.0)
    rows = []

    def emit(ancestor: str, depth: int):
        level = sorted(children.get(ancestor, []),
                       key=lambda p: -rollup[p]["total_s"])
        for path in level:
            stats = rollup[path]
            frac = stats["total_s"] / top_total if top_total else 0.0
            suffix = path[len(ancestor) + 1:] if ancestor else path
            label = ("&nbsp;" * 4 * depth) + _esc(suffix)
            rows.append(
                '<div class="span-row">'
                f'<div class="span-name" title="{_esc(path)}">{label}</div>'
                '<div class="span-bar-rail">'
                f'<div class="span-bar" style="left:0;'
                f'width:{min(frac, 1.0) * 100:.2f}%"></div></div>'
                f'<div class="span-secs">{_fmt_seconds(stats["total_s"])}'
                f' &middot; {stats["count"]}&times;'
                f' &middot; {frac * 100:.1f}%</div></div>'
            )
            emit(path, depth + 1)

    emit("", 0)
    hot = summary.get("span_hotspots") or []
    hot_html = ""
    if hot:
        hot_html = ('<p class="note">Hotspots (self time): '
                    + ", ".join(
                        f"<code>{_esc(h['path'])}</code> "
                        f"{_fmt_seconds(h['self_s'])}"
                        for h in hot) + "</p>")
    return f'<div class="spans">{"".join(rows)}</div>{hot_html}'


def _utilization_section(summary: dict) -> str:
    """The port's summary has no ``utilization`` block (no ``compile``
    events, no TPU peak table), so this is the duration-only note."""
    return ('<p class="note">No cost-analysis numbers on this stream (the '
            "port writes no <code>compile</code> events) — spans above carry "
            "the duration-only view.</p>")


def _memory_section(chunks) -> str:
    dev = [(c.get("epoch"), (c.get("memory") or {}).get("peak_bytes_in_use"))
           for c in chunks]
    host = [(c.get("epoch"),
             (c.get("host_memory") or {}).get(
                 "peak_rss_bytes", (c.get("host_memory") or {}).get(
                     "rss_bytes")))
            for c in chunks]
    dev = [(e, v) for e, v in dev if v is not None]
    host = [(e, v) for e, v in host if v is not None]
    if not dev and not host:
        return ('<p class="note">No memory stats on this stream (CPU '
                "backend without the host-RSS fallback, or a pre-span "
                "schema).</p>")
    tiles = _tiles([
        ("device peak", _fmt_bytes(max(v for _, v in dev)) if dev else None),
        ("host RSS peak", _fmt_bytes(max(v for _, v in host)) if host else None),
    ])
    series = []
    if dev:
        series.append(("device peak bytes", "--series-1",
                       [(e, v / 2**20) for e, v in dev]))
    if host:
        series.append(("host RSS", "--series-2",
                       [(e, v / 2**20) for e, v in host]))
    chart = _line_chart("Memory high-water (MiB)", series) if series else ""
    return tiles + f'<div class="charts">{chart}</div>'


def _faults_section(summary: dict) -> str:
    """Fault-drill evidence (docs/robustness.md): injected vs detected vs
    recovered tiles plus the per-injection join. Empty string for normal
    (uninjected) runs — the section only renders when drills ran."""
    faults = summary.get("faults")
    if not faults:
        return ""
    ttd = (faults.get("time_to_detect_s") or {}).get("mean")
    ttr = (faults.get("time_to_recover_s") or {}).get("mean")
    tiles = _tiles([
        ("injected", faults.get("injected")),
        ("detected", faults.get("detected")),
        ("recovered", faults.get("recovered")),
        ("mean detect", _fmt_seconds(ttd) if ttd is not None else None),
        ("mean recover", _fmt_seconds(ttr) if ttr is not None else None),
    ])
    rows = []
    for f in faults.get("faults", []):
        det = ("✓ " + _esc(str(f.get("detected_by", "")))
               if f.get("detected") else "✗ UNDETECTED")
        rec = "✓" if f.get("recovered") else "✗"
        ttd_s = f.get("time_to_detect_s")
        ttr_s = f.get("time_to_recover_s")
        rows.append(
            "<tr>"
            f"<td><code>{_esc(f.get('spec') or f.get('kind', '?'))}</code></td>"
            f"<td>{det}</td>"
            f"<td>{_fmt_seconds(ttd_s) if ttd_s is not None else '—'}</td>"
            f"<td>{rec}</td>"
            f"<td>{_fmt_seconds(ttr_s) if ttr_s is not None else '—'}</td>"
            "</tr>"
        )
    undetected = faults.get("undetected") or []
    warn = ""
    if undetected:
        warn = ('<p class="note">⚠ undetected injected fault(s): '
                + ", ".join(f"<code>{_esc(k)}</code>" for k in undetected)
                + " — <code>telemetry compare</code> gates on this.</p>")
    table = ("<table><thead><tr><th>injection</th><th>detected</th>"
             "<th>t-detect</th><th>recovered</th><th>t-recover</th>"
             "</tr></thead><tbody>" + "".join(rows) + "</tbody></table>")
    return ("<h2>Fault drills</h2>"
            '<p class="note">Deliberate injections '
            "(<code>dib_tpu_torch/faults</code>) joined with the mitigations "
            "they provoked.</p>" + tiles + table + warn)


def _slo_section(events) -> str:
    """Durable SLO residue (telemetry/slo.py): alert and info-plane
    transition events on the stream. Empty for runs with neither."""
    alerts = [e for e in events if e.get("type") == "alert"]
    transitions = [e for e in events if e.get("type") == "transition"]
    if not alerts and not transitions:
        return ""
    parts = ["<h2>SLO alerts &amp; info-plane transitions</h2>"]
    if alerts:
        rows = "".join(
            f"<tr><td>{_esc(a.get('rule', '?'))}</td>"
            f"<td>{_esc(a.get('metric', '?'))}</td>"
            f"<td>{_esc(a.get('value'))}</td>"
            f"<td>{_esc(a.get('bound', '?'))} {_esc(a.get('budget'))}</td>"
            f"<td>{_esc(a.get('severity', '?'))}</td>"
            f"<td>{_esc(a.get('source', '?'))}</td></tr>"
            for a in alerts)
        parts.append(
            '<p class="note">⚠ budgets violated (SLO.json, '
            "<code>telemetry check</code>):</p>"
            "<table><thead><tr><th>rule</th><th>metric</th><th>observed</th>"
            "<th>budget</th><th>severity</th><th>source</th></tr></thead>"
            f"<tbody>{rows}</tbody></table>")
    if transitions:
        rows = "".join(
            f"<tr><td>{_esc(t.get('channel', '?'))}</td>"
            f"<td>{_esc(t.get('epoch', '?'))}</td>"
            f"<td>{_esc(t.get('direction', '?'))}</td>"
            f"<td>{_esc(t.get('kl_before'))} → {_esc(t.get('kl_after'))}</td>"
            f"<td>{_esc(t.get('beta', '—'))}</td></tr>"
            for t in transitions)
        parts.append(
            '<p class="note">Per-channel KL threshold crossings — the '
            "info-plane transitions the β-grid refinement targets:</p>"
            "<table><thead><tr><th>channel</th><th>epoch</th>"
            "<th>direction</th><th>KL (nats)</th><th>β</th></tr></thead>"
            f"<tbody>{rows}</tbody></table>")
    return "".join(parts)


def render_report(path: str, run_id: str | None = None,
                  process_index: int | None = None) -> str:
    """The report HTML for one events.jsonl (or its run dir)."""
    events = list(read_events(path, process_index=process_index))
    if run_id is not None:
        events = [e for e in events if e.get("run") == run_id]
    summary = summarize(path, process_index=process_index, run_id=run_id)

    chunks = [e for e in events if e.get("type") == "chunk"]
    mi = [e for e in events if e.get("type") == "mi_bounds"]

    def chunk_series(key):
        pts = []
        for c in chunks:
            v = c.get(key)
            if isinstance(v, list):   # sweep runs carry [R] lists
                vals = [x for x in v if isinstance(x, (int, float))]
                v = sum(vals) / len(vals) if vals else None
            if isinstance(v, (int, float)):
                pts.append((c.get("epoch", 0), v))
        return pts

    charts = [
        _line_chart("Throughput (steps/s)",
                    [("steps/s", "--series-1", chunk_series("steps_per_s"))]),
        _line_chart("Loss",
                    [("train", "--series-1", chunk_series("loss")),
                     ("validation", "--series-2", chunk_series("val_loss"))]),
    ]
    kl = chunk_series("kl_total")
    if not kl:
        kl = []
        for c in chunks:
            v = c.get("kl_per_feature")
            if isinstance(v, list):
                vals = [x for x in v if isinstance(x, (int, float))]
                if vals:
                    kl.append((c.get("epoch", 0), sum(vals)))
    charts.append(_line_chart("Total KL (per-replica mean for sweeps)",
                              [("total KL", "--series-3", kl)]))
    charts = [c for c in charts if c]

    mi_chart = ""
    if mi:
        def mean_bits(e, which):
            vals = e.get(f"{which}_bits")
            if vals is None and e.get(f"{which}_nats") is not None:
                vals = [x / math.log(2.0) for x in e[f"{which}_nats"]
                        if isinstance(x, (int, float))]
            if isinstance(vals, list):
                vals = [x for x in vals if isinstance(x, (int, float))]
                return sum(vals) / len(vals) if vals else None
            return vals if isinstance(vals, (int, float)) else None

        lower = [(e.get("epoch", 0), mean_bits(e, "lower")) for e in mi]
        upper = [(e.get("epoch", 0), mean_bits(e, "upper")) for e in mi]
        lower = [(x, y) for x, y in lower if y is not None]
        upper = [(x, y) for x, y in upper if y is not None]
        mi_chart = _line_chart(
            "MI sandwich bounds (mean bits per feature)",
            [("lower bound", "--series-1", lower),
             ("upper bound", "--series-2", upper)],
            band_pair=(0, 1), width=640, height=180,
        )

    status = summary.get("status", "?")
    wall = summary.get("wall_clock_s")
    header_tiles = _tiles([
        ("status", status),
        ("device", f"{summary.get('device_kind', '?')} ×"
                   f"{summary.get('device_count', '?')}"),
        ("steps/s", summary.get("steps_per_s")),
        ("steady steps/s", summary.get("steady_steps_per_s")),
        ("total steps", summary.get("total_steps")),
        ("wall clock", _fmt_seconds(wall) if wall else None),
        ("launches", summary.get("launches")),
        ("mitigations", summary.get("mitigations_total") or None),
    ])
    run_label = summary.get("run_id", "run")
    git = summary.get("git_sha")
    sub = (f"run <code>{_esc(run_label)}</code>"
           + (f" · git <code>{_esc(str(git)[:12])}</code>" if git else "")
           + (f" · config <code>{_esc(summary['config_hash'])}</code>"
              if summary.get("config_hash") else ""))

    summary_json = _esc(json.dumps(summary, indent=1, default=str))
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>dib-tpu run report — {_esc(run_label)}</title>
<style>{_CSS}</style></head>
<body>
<h1>dib-tpu run report</h1>
<p class="sub">{sub}</p>
{header_tiles}
<h2>Span breakdown</h2>
<p class="note">Blocked wall-clock per trace span
(<code>telemetry/trace.py</code>); bars are fractions of the top-level
total, indented by nesting. The same names appear in captured CUDA traces
as NVTX ranges.</p>
{_span_section(summary)}
<h2>Training trajectory</h2>
<div class="charts">{''.join(charts)}</div>
<h2>MI-bound trajectory</h2>
{mi_chart or '<p class="note">No mi_bounds events in this stream.</p>'}
<h2>Memory</h2>
{_memory_section(chunks)}
<h2>Roofline utilization</h2>
{_utilization_section(summary)}
{_faults_section(summary)}
{_slo_section(events)}
<details><summary>Full summary record (table view)</summary>
<pre>{summary_json}</pre></details>
</body></html>
"""


def write_report(path: str, out: str | None = None,
                 run_id: str | None = None,
                 process_index: int | None = None) -> str:
    """Render and write the report; returns the output path (default:
    ``report.html`` next to the events file)."""
    html_text = render_report(path, run_id=run_id,
                              process_index=process_index)
    if out is None:
        out = os.path.join(
            os.path.dirname(resolve_events_path(path)), "report.html")
    with open(out, "w") as f:
        f.write(html_text)
    return out


# ------------------------------------------------------------- fleet index
def render_index(runs_root: str, out_dir: str | None = None) -> str:
    """The multi-run index page for a runs root (``telemetry report
    --index``): one row per registered run linking its per-run report,
    plus the bench perf trajectory as table + SVG chart. Same
    self-contained HTML contract as the per-run report."""
    from dib_tpu_torch.telemetry.registry import RunRegistry

    registry = RunRegistry(runs_root)
    out_dir = out_dir or runs_root
    latest = registry.latest()
    bench = registry.bench_history()

    rows = []
    for run_id, entry in sorted(latest.items(),
                                key=lambda kv: kv[1].get("t", 0.0)):
        metrics = entry.get("metrics") or {}
        prov = entry.get("provenance") or {}
        run_dir = entry.get("run_dir") or ""
        report_path = os.path.join(run_dir, "report.html")
        # link relative to where the index page lands, when expressible
        try:
            href = os.path.relpath(report_path, out_dir)
        except ValueError:   # different drive (windows): absolute
            href = report_path
        name = (f'<a href="{_esc(href)}">{_esc(run_id)}</a>'
                if run_dir and os.path.exists(report_path)
                else _esc(run_id))
        alerts = metrics.get("alerts", 0)
        rows.append(
            "<tr>"
            f"<td>{name}</td>"
            f"<td>{_esc(entry.get('status', '?'))}</td>"
            f"<td>{_esc(prov.get('device_kind', '—'))}</td>"
            f"<td>{_esc(_num(metrics.get('steps_per_s')))}</td>"
            f"<td>{_esc(_num(metrics.get('mfu')))}</td>"
            f"<td>{_esc(_num(metrics.get('final_val_loss')))}</td>"
            f"<td>{_esc(_num(metrics.get('serving_p99_ms')))}</td>"
            f"<td>{'⚠ ' if alerts else ''}{alerts or '—'}</td>"
            f"<td>{_esc(_num(metrics.get('mitigations_total', 0)))}</td>"
            "</tr>")
    runs_table = (
        "<table><thead><tr><th>run</th><th>status</th><th>device</th>"
        "<th>steps/s</th><th>MFU</th><th>val loss</th><th>serve p99 ms</th>"
        "<th>alerts</th><th>mitigations</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
        if rows else
        '<p class="note">No runs registered yet — runs register at '
        "run_end when a runs root is configured (<code>--runs-root</code> "
        "/ <code>DIB_RUNS_ROOT</code>; docs/observability.md).</p>")

    trajectory_html = ('<p class="note">No bench entries yet — '
                       "<code>bench.py</code> appends every invocation's "
                       "headline numbers here.</p>")
    if bench:
        # the minutes chart is the north-star projection only — other
        # bench kinds (serve req/s) carry different units and would
        # scramble the axis
        minutes = [(i, e.get("value")) for i, e in enumerate(bench)
                   if isinstance(e.get("value"), (int, float))
                   and e.get("unit") == "minutes"]
        steps = [(i, e.get("steps_per_s")) for i, e in enumerate(bench)
                 if isinstance(e.get("steps_per_s"), (int, float))]
        mfu = [(i, e.get("mfu") * 100) for i, e in enumerate(bench)
               if isinstance(e.get("mfu"), (int, float))]
        charts = [c for c in (
            _line_chart("Projected north-star sweep (minutes)",
                        [("minutes", "--series-1", minutes)],
                        x_label="bench #"),
            _line_chart("Sweep throughput (steps/s)",
                        [("steps/s", "--series-2", steps)],
                        x_label="bench #"),
            _line_chart("MFU (%)", [("mfu %", "--series-3", mfu)],
                        x_label="bench #"),
        ) if c]
        bench_rows = "".join(
            "<tr>"
            f"<td>{i}</td>"
            f"<td>{_esc(e.get('measured_at', '—'))}</td>"
            f"<td>{_esc(_num(e.get('value')))}</td>"
            f"<td>{_esc(e.get('unit', '—'))}</td>"
            f"<td>{_esc(_num(e.get('steps_per_s')))}</td>"
            f"<td>{_esc(_num(e.get('mfu')))}</td>"
            f"<td>{_esc(_num(e.get('vs_baseline')))}</td>"
            f"<td>{_esc(e.get('device_kind', '—'))}"
            f"{' [degraded]' if e.get('degraded') else ''}</td></tr>"
            for i, e in enumerate(bench))
        trajectory_html = (
            f'<div class="charts">{"".join(charts)}</div>'
            "<table><thead><tr><th>#</th><th>measured at</th><th>value</th>"
            "<th>unit</th><th>steps/s</th><th>MFU</th><th>vs baseline</th>"
            "<th>device</th></tr></thead>"
            f"<tbody>{bench_rows}</tbody></table>")

    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>dib-tpu fleet index — {_esc(runs_root)}</title>
<style>{_CSS}</style></head>
<body>
<h1>dib-tpu fleet index</h1>
<p class="sub">runs root <code>{_esc(os.path.abspath(runs_root))}</code>
 · {len(latest)} run(s) · {len(bench)} bench point(s)</p>
<h2>Runs</h2>
<p class="note">Latest registry entry per run
(<code>{_esc(os.path.join(runs_root, 'index.jsonl'))}</code>, append-only);
run names link to each run's per-run report where one has been
rendered.</p>
{runs_table}
<h2>Performance trajectory</h2>
<p class="note">Every <code>bench.py</code> invocation's headline numbers,
oldest first — the cross-run record the MFU and serving campaigns gate
against (<code>telemetry runs trajectory</code> is the terminal view).</p>
{trajectory_html}
</body></html>
"""


def _num(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def write_index(runs_root: str, out: str | None = None) -> str:
    """Render and write the fleet index page (default:
    ``<runs_root>/index.html``)."""
    out = out or os.path.join(runs_root, "index.html")
    html_text = render_index(runs_root, out_dir=os.path.dirname(out) or ".")
    with open(out, "w") as f:
        f.write(html_text)
    return out
