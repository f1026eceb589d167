"""Lattice debug report: a self-contained HTML visualizer (port of
``oscillink_tpu/utils/debug_report.py``; the render code is a copy, the
per-node components and the alignment come from the port's lattice on its
device).

The reference roadmap plans an `oscillink-debug` package ("energy surface,
solver traces, null-point heat maps, settling animation") and never ships
it.  This module generates the egress-free equivalent: ONE static HTML file
(inline SVG + a small vanilla-JS hover layer, no external assets) from a
live lattice:

  * a KPI row — deltaH_total, U* iterations/residual, graph build ms,
    average degree, null-point count;
  * settle dynamics traces — per-step energy drop and lattice temperature
    (the receipt-dynamics metrics, run here over ``settle_steps`` implicit
    Euler steps);
  * top coherence-drop nodes and top null-point z-scores as labeled bars
    (the z=3 flag threshold drawn as a hairline);
  * the query-alignment distribution of the settled state;
  * bundle + null-point tables (every charted value is also in a table).

Charts follow the repo's dataviz conventions: single-hue marks, thin
geometry, recessive hairline grid, direct value labels, hover tooltips,
and a light/dark scheme driven by CSS custom properties.
"""

from __future__ import annotations

import html
import json
import math
import os
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["generate_debug_report"]

# reference palette instance (validated): slot-1 blue + surfaces/text tokens
_CSS = """
:root {
  color-scheme: light dark;
  --surface: #fcfcfb; --surface-2: #f1f0ee; --grid: #e4e3e0;
  --ink: #0b0b0b; --ink-2: #52514e; --ink-3: #8a8984;
  --accent: #2a78d6; --accent-wash: rgba(42, 120, 214, 0.10);
}
@media (prefers-color-scheme: dark) {
  :root:not([data-theme="light"]) {
    --surface: #1a1a19; --surface-2: #242423; --grid: #34342f;
    --ink: #ffffff; --ink-2: #c3c2b7; --ink-3: #8a8984;
    --accent: #3987e5; --accent-wash: rgba(57, 135, 229, 0.12);
  }
}
:root[data-theme="dark"] {
  --surface: #1a1a19; --surface-2: #242423; --grid: #34342f;
  --ink: #ffffff; --ink-2: #c3c2b7; --ink-3: #8a8984;
  --accent: #3987e5; --accent-wash: rgba(57, 135, 229, 0.12);
}
* { box-sizing: border-box; }
body { background: var(--surface); color: var(--ink);
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
  margin: 0; padding: 24px; }
h1 { font-size: 18px; margin: 0 0 2px; }
.sub { color: var(--ink-2); font-size: 12px; margin-bottom: 18px;
  word-break: break-all; }
.kpis { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 20px; }
.tile { background: var(--surface-2); border-radius: 8px; padding: 10px 14px;
  min-width: 128px; }
.tile .lbl { color: var(--ink-2); font-size: 12px; }
.tile .val { font-weight: 600; font-size: 22px; }
.grid2 { display: grid; grid-template-columns: repeat(auto-fit,
  minmax(340px, 1fr)); gap: 18px; }
.card { background: var(--surface-2); border-radius: 10px; padding: 14px; }
.card h2 { font-size: 13px; font-weight: 600; margin: 0 0 2px; }
.card .note { color: var(--ink-2); font-size: 12px; margin: 0 0 8px; }
svg text { fill: var(--ink-2); font-size: 11px; }
svg .vlab { fill: var(--ink); font-size: 11px; }
svg .gridline { stroke: var(--grid); stroke-width: 1; }
svg .thresh { stroke: var(--ink-3); stroke-width: 1; stroke-dasharray: none; }
table { border-collapse: collapse; width: 100%; font-size: 12px; }
th { text-align: left; color: var(--ink-2); font-weight: 500;
  border-bottom: 1px solid var(--grid); padding: 4px 8px; }
td { border-bottom: 1px solid var(--grid); padding: 4px 8px;
  font-variant-numeric: tabular-nums; }
#tip { position: fixed; pointer-events: none; background: var(--surface);
  color: var(--ink); border: 1px solid var(--grid); border-radius: 6px;
  padding: 6px 9px; font-size: 12px; display: none; z-index: 10;
  box-shadow: 0 2px 8px rgba(0,0,0,0.18); }
#tip .v { font-weight: 600; }
#tip .k { color: var(--ink-2); }
.toggle { float: right; background: var(--surface-2); color: var(--ink-2);
  border: 1px solid var(--grid); border-radius: 6px; padding: 4px 10px;
  cursor: pointer; font-size: 12px; }
.crosshair { stroke: var(--ink-3); stroke-width: 1; display: none; }
"""

_JS = """
(function () {
  var tip = document.getElementById('tip');
  function show(evt, rows) {
    while (tip.firstChild) tip.removeChild(tip.firstChild);
    rows.forEach(function (r) {
      var d = document.createElement('div');
      var v = document.createElement('span'); v.className = 'v';
      v.textContent = r[1];
      var k = document.createElement('span'); k.className = 'k';
      k.textContent = ' ' + r[0];
      d.appendChild(v); d.appendChild(k); tip.appendChild(d);
    });
    tip.style.display = 'block';
    var x = evt.clientX + 12, y = evt.clientY + 12;
    var bw = tip.offsetWidth, bh = tip.offsetHeight;
    if (x + bw > window.innerWidth - 8) x = evt.clientX - bw - 12;
    if (y + bh > window.innerHeight - 8) y = evt.clientY - bh - 12;
    tip.style.left = x + 'px'; tip.style.top = y + 'px';
  }
  function hide() { tip.style.display = 'none'; }
  document.querySelectorAll('[data-tip]').forEach(function (el) {
    el.addEventListener('pointermove', function (e) {
      show(e, JSON.parse(el.getAttribute('data-tip')));
    });
    el.addEventListener('pointerleave', hide);
  });
  // line charts: crosshair snapping to the nearest step
  document.querySelectorAll('svg[data-line]').forEach(function (svg) {
    var pts = JSON.parse(svg.getAttribute('data-line'));
    var ch = svg.querySelector('.crosshair');
    svg.addEventListener('pointermove', function (e) {
      var r = svg.getBoundingClientRect();
      var sx = svg.viewBox.baseVal.width / r.width;
      var mx = (e.clientX - r.left) * sx;
      var best = 0, bd = 1e9;
      pts.forEach(function (p, i) {
        var d = Math.abs(p[0] - mx); if (d < bd) { bd = d; best = i; }
      });
      var p = pts[best];
      ch.setAttribute('x1', p[0]); ch.setAttribute('x2', p[0]);
      ch.style.display = 'block';
      show(e, [[p[3], p[2]]]);
    });
    svg.addEventListener('pointerleave', function () {
      ch.style.display = 'none'; hide();
    });
  });
  var btn = document.getElementById('theme');
  btn.addEventListener('click', function () {
    var cur = document.documentElement.getAttribute('data-theme');
    var dark = window.matchMedia('(prefers-color-scheme: dark)').matches;
    var now = (cur || (dark ? 'dark' : 'light')) === 'dark' ? 'light' : 'dark';
    document.documentElement.setAttribute('data-theme', now);
  });
})();
"""


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1e6:
        return f"{v / 1e6:.2f}M"
    if a >= 1e4:
        return f"{v / 1e3:.1f}K"
    if a >= 100:
        return f"{v:,.0f}"
    if a >= 1:
        return f"{v:.2f}"
    if a >= 1e-3:
        return f"{v:.4f}"
    return f"{v:.2e}"


def _nice_ticks(lo: float, hi: float, n: int = 4) -> list[float]:
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / max(n, 1)
    mag = 10 ** math.floor(math.log10(raw))
    for m in (1, 2, 2.5, 5, 10):
        if m * mag >= raw:
            step = m * mag
            break
    start = math.ceil(lo / step) * step
    out = []
    t = start
    while t <= hi + 1e-12:
        out.append(round(t, 10))
        t += step
    return out or [lo, hi]


def _tile(label: str, value: str) -> str:
    return (
        f'<div class="tile"><div class="lbl">{html.escape(label)}</div>'
        f'<div class="val">{html.escape(value)}</div></div>'
    )


def _line_chart(title: str, note: str, ys: list[float], ylab: str) -> str:
    """Single-series line with markers, hairline grid, crosshair tooltip."""
    W, H, L, R, T, B = 360, 170, 46, 12, 12, 26
    n = len(ys)
    lo = min(0.0, min(ys)) if ys else 0.0
    hi = max(ys) if ys else 1.0
    ticks = _nice_ticks(lo, hi)
    lo, hi = min(lo, ticks[0]), max(hi, ticks[-1])
    span = (hi - lo) or 1.0

    def X(i):
        return L + (W - L - R) * (i / max(n - 1, 1))

    def Y(v):
        return T + (H - T - B) * (1 - (v - lo) / span)

    grid = "".join(
        f'<line class="gridline" x1="{L}" x2="{W - R}" y1="{Y(t):.1f}" '
        f'y2="{Y(t):.1f}"/><text x="{L - 6}" y="{Y(t) + 3:.1f}" '
        f'text-anchor="end">{_fmt(t)}</text>'
        for t in ticks
    )
    pts = [(round(X(i), 1), round(Y(v), 1), _fmt(v), f"{ylab} @ step {i + 1}")
           for i, v in enumerate(ys)]
    path = "M" + " L".join(f"{x},{y}" for x, y, *_ in pts)
    dots = "".join(
        f'<circle cx="{x}" cy="{y}" r="4" fill="var(--accent)" '
        f'stroke="var(--surface-2)" stroke-width="2"/>'
        for x, y, *_ in pts
    )
    xlabels = "".join(
        f'<text x="{X(i):.1f}" y="{H - 8}" text-anchor="middle">{i + 1}</text>'
        for i in range(n)
    )
    end_label = (
        f'<text class="vlab" x="{pts[-1][0] - 6}" y="{pts[-1][1] - 8}" '
        f'text-anchor="end">{pts[-1][2]}</text>'
        if pts else ""
    )
    data = json.dumps(pts)
    return f"""<div class="card"><h2>{html.escape(title)}</h2>
<p class="note">{html.escape(note)}</p>
<svg viewBox="0 0 {W} {H}" data-line='{data}'>
{grid}
<line class="crosshair" y1="{T}" y2="{H - B}" x1="0" x2="0"/>
<path d="{path}" fill="none" stroke="var(--accent)" stroke-width="2"
 stroke-linejoin="round" stroke-linecap="round"/>
{dots}{end_label}{xlabels}
</svg></div>"""


def _bar_chart(
    title: str,
    note: str,
    labels: list[str],
    values: list[float],
    tips: Optional[list[list[list[str]]]] = None,
    threshold: Optional[float] = None,
) -> str:
    """Horizontal bars: ≤18px thick, 4px rounded data-end (square at the
    baseline), value at the tip, per-mark tooltip."""
    n = len(values)
    W, L, R = 360, 64, 46
    bar_h, gap = 16, 6
    T = 8
    H = T + n * (bar_h + gap) + 10
    vmax = max([abs(v) for v in values] + [threshold or 0.0, 1e-12])
    inner = W - L - R

    def XW(v):
        return inner * (abs(v) / vmax)

    rows = []
    for i, (lab, v) in enumerate(zip(labels, values)):
        y = T + i * (bar_h + gap)
        w = max(XW(v), 1.0)
        r = min(4.0, w)
        d = (
            f"M{L},{y} h{w - r:.1f} a{r},{r} 0 0 1 {r},{r} "
            f"v{bar_h - 2 * r} a{r},{r} 0 0 1 -{r},{r} h-{w - r:.1f} z"
        )
        tip = tips[i] if tips else [[lab, _fmt(v)]]
        rows.append(
            f'<g data-tip=\'{json.dumps(tip)}\'>'
            f'<rect x="{L}" y="{y - 2}" width="{inner}" height="{bar_h + 4}"'
            f' fill="transparent"/>'
            f'<path d="{d}" fill="var(--accent)"/>'
            f'<text x="{L - 6}" y="{y + bar_h - 4}" text-anchor="end">'
            f"{html.escape(lab)}</text>"
            f'<text class="vlab" x="{L + w + 5:.1f}" y="{y + bar_h - 4}">'
            f"{_fmt(v)}</text></g>"
        )
    thresh = ""
    if threshold is not None and threshold <= vmax:
        tx = L + XW(threshold)
        thresh = (
            f'<line class="thresh" x1="{tx:.1f}" x2="{tx:.1f}" y1="{T - 4}" '
            f'y2="{H - 8}"/><text x="{tx + 3:.1f}" y="{T + 6}">'
            f"z={_fmt(threshold)}</text>"
        )
    return f"""<div class="card"><h2>{html.escape(title)}</h2>
<p class="note">{html.escape(note)}</p>
<svg viewBox="0 0 {W} {H}">{''.join(rows)}{thresh}</svg></div>"""


def _hist_chart(title: str, note: str, data: np.ndarray, bins: int = 16) -> str:
    """Column histogram, one hue, per-column tooltip."""
    counts, edges = np.histogram(np.asarray(data, dtype=np.float64), bins=bins)
    W, H, L, R, T, B = 360, 160, 40, 10, 10, 26
    cmax = max(int(counts.max()), 1)
    inner_w = W - L - R
    col_w = inner_w / bins

    def Y(c):
        return T + (H - T - B) * (1 - c / cmax)

    cols = []
    for i, c in enumerate(counts):
        x = L + i * col_w + 1
        w = max(col_w - 2, 1)
        y = Y(int(c))
        h = (H - B) - y
        if h <= 0:
            continue
        r = min(4.0, w / 2, h)
        # rounded-top column path, square at the baseline
        d = (
            f"M{x:.1f},{H - B} v-{max(h - r, 0):.1f} "
            f"a{r},{r} 0 0 1 {r},-{r} h{max(w - 2 * r, 0):.1f} "
            f"a{r},{r} 0 0 1 {r},{r} v{max(h - r, 0):.1f} z"
        )
        tip = [[f"[{_fmt(edges[i])}, {_fmt(edges[i + 1])})", str(int(c))]]
        cols.append(
            f'<g data-tip=\'{json.dumps(tip)}\'>'
            f'<rect x="{x:.1f}" y="{T}" width="{w:.1f}" height="{H - B - T}"'
            f' fill="transparent"/>'
            f'<path d="{d}" fill="var(--accent)"/></g>'
        )
    ticks = "".join(
        f'<text x="{L + inner_w * f:.1f}" y="{H - 8}" text-anchor="middle">'
        f"{_fmt(float(edges[0] + (edges[-1] - edges[0]) * f))}</text>"
        for f in (0.0, 0.5, 1.0)
    )
    base = (
        f'<line class="gridline" x1="{L}" x2="{W - R}" y1="{H - B}" '
        f'y2="{H - B}"/>'
    )
    return f"""<div class="card"><h2>{html.escape(title)}</h2>
<p class="note">{html.escape(note)}</p>
<svg viewBox="0 0 {W} {H}">{base}{''.join(cols)}{ticks}</svg></div>"""


def _table(title: str, headers: list[str], rows: list[list[str]]) -> str:
    head = "".join(f"<th>{html.escape(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(c)}</td>" for c in r) + "</tr>"
        for r in rows
    )
    return (
        f'<div class="card"><h2>{html.escape(title)}</h2>'
        f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody>"
        f"</table></div>"
    )


def generate_debug_report(
    lat: Any,
    path: Optional[str] = None,
    *,
    settle_steps: int = 5,
    settle_dt: float = 1.0,
    top_nodes: int = 12,
    bundle_k: int = 8,
) -> str:
    """Render the lattice debug report; returns the HTML (and writes it to
    ``path`` when given).  Runs ``settle_steps`` implicit-Euler steps with
    receipt dynamics enabled to collect the traces, then a full receipt."""
    from ..ops.receipts import per_node_components

    # --- collect dynamics over settle steps (env saved/restored) ---
    prev = os.environ.get("OSCILLINK_RECEIPT_DYNAMICS")
    os.environ["OSCILLINK_RECEIPT_DYNAMICS"] = "1"
    steps: list[dict[str, Any]] = []
    try:
        for _ in range(settle_steps):
            info = lat.settle(dt=settle_dt, max_iters=12, tol=1e-3)
            dyn = lat._last_dynamics or {}
            steps.append(
                {
                    "deltaH": float(dyn.get("step_deltaH", 0.0)),
                    "temperature": float(dyn.get("temperature", 0.0)),
                    "iters": int(info.get("iters", 0)),
                    "res": float(info.get("res", 0.0)),
                }
            )
    finally:
        if prev is None:
            os.environ.pop("OSCILLINK_RECEIPT_DYNAMICS", None)
        else:
            os.environ["OSCILLINK_RECEIPT_DYNAMICS"] = prev

    rec = lat.receipt()
    meta = rec["meta"]

    # --- per-node components + alignment (on the lattice's device) ---
    Ustar = lat._solve_ustar_device()
    coh, anchor, query = (
        t.cpu().numpy()
        for t in per_node_components(
            lat._graph, lat._Y_dev, Ustar, lat._lam(), lat._B_dev, lat._psi_dev
        )
    )
    u_n = Ustar / (torch.linalg.vector_norm(Ustar, dim=1, keepdim=True) + 1e-12)
    p_n = lat._psi_dev / (torch.linalg.vector_norm(lat._psi_dev) + 1e-12)
    align = (u_n @ p_n).cpu().numpy()

    top = np.argsort(-np.asarray(coh))[:top_nodes]
    nulls = sorted(
        rec.get("null_points", []), key=lambda e: -float(e.get("z", 0.0))
    )
    bundle = lat.bundle(k=min(bundle_k, lat.N))

    kpis = "".join(
        [
            _tile("deltaH total", _fmt(float(rec["deltaH_total"]))),
            _tile("U* iters / residual",
                  f"{meta['ustar_iters']} / {_fmt(float(meta['ustar_res']))}"),
            _tile("graph build", f"{_fmt(float(meta['graph_build_ms']))} ms"),
            _tile("avg degree", _fmt(float(meta["avg_degree"]))),
            _tile("null points", str(len(nulls))),
            _tile("N x D", f"{lat.N} x {lat.D}"),
        ]
    )

    charts = [
        _line_chart(
            "Energy drop per settle step",
            f"step deltaH over {settle_steps} implicit-Euler steps "
            f"(dt={settle_dt})",
            [s["deltaH"] for s in steps],
            "deltaH",
        ),
        _line_chart(
            "Lattice temperature",
            "mean squared node movement per step (receipt dynamics)",
            [s["temperature"] for s in steps],
            "temperature",
        ),
        _bar_chart(
            "Top coherence-drop nodes",
            "per-node coherence component of the receipt (largest first)",
            [f"node {int(i)}" for i in top],
            [float(coh[i]) for i in top],
            tips=[
                [
                    ["coherence drop", _fmt(float(coh[i]))],
                    ["anchor penalty", _fmt(float(anchor[i]))],
                    ["query term", _fmt(float(query[i]))],
                    ["align", _fmt(float(align[i]))],
                ]
                for i in top
            ],
        ),
        _bar_chart(
            "Null-point z-scores",
            "most anomalous edges (z > 3 crosses the flag threshold)",
            [f"{e['edge'][0]}-{e['edge'][1]}" for e in nulls[:top_nodes]],
            [float(e["z"]) for e in nulls[:top_nodes]],
            tips=[
                [
                    ["z", _fmt(float(e["z"]))],
                    ["residual", _fmt(float(e["residual"]))],
                    ["edge", f"{e['edge'][0]} - {e['edge'][1]}"],
                ]
                for e in nulls[:top_nodes]
            ],
            threshold=3.0,
        ),
        _hist_chart(
            "Query alignment distribution",
            "cos(U*, psi) across settled nodes",
            align,
        ),
        _table(
            "Bundle (top-k)",
            ["id", "score", "align"],
            [
                [str(e["id"]), _fmt(float(e["score"])), _fmt(float(e["align"]))]
                for e in bundle
            ],
        ),
        _table(
            "Settle trace",
            ["step", "deltaH", "temperature", "CG iters", "residual"],
            [
                [str(i + 1), _fmt(s["deltaH"]), _fmt(s["temperature"]),
                 str(s["iters"]), _fmt(s["res"])]
                for i, s in enumerate(steps)
            ],
        ),
        _table(
            "Null points",
            ["edge", "z", "residual"],
            [
                [f"{e['edge'][0]} - {e['edge'][1]}", _fmt(float(e["z"])),
                 _fmt(float(e["residual"]))]
                for e in nulls[: 2 * top_nodes]
            ],
        ),
    ]

    doc = f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Oscillink debug report</title>
<style>{_CSS}</style></head>
<body>
<button class="toggle" id="theme">light / dark</button>
<h1>Oscillink lattice debug report</h1>
<p class="sub">state_sig {html.escape(str(meta.get("state_sig", "")))} ·
N={lat.N} D={lat.D} k={lat._kneighbors} ·
lamG={lat.lamG} lamC={lat.lamC} lamQ={lat.lamQ}</p>
<div class="kpis">{kpis}</div>
<div class="grid2">{''.join(charts)}</div>
<div id="tip"></div>
<script>{_JS}</script>
</body></html>"""

    if path:
        with open(path, "w") as f:
            f.write(doc)
    return doc
