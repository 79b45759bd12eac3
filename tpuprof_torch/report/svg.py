"""Inline-SVG histogram rendering (copy of ``tpuprof/report/svg.py``).

Replaces the reference's matplotlib-figure→PNG→base64 pipeline — the
report-side hot spot flagged in SURVEY.md §3.1 — with direct SVG bar
generation: no image library, crisp at any zoom, and the full + mini
variants the templates expect (histogram / mini_histogram fields, SURVEY
§2.1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from tpuprof_torch.report.formatters import fmt_number

Histogram = Tuple[np.ndarray, np.ndarray]  # (counts[bins], edges[bins+1])


def histogram_svg(hist: Optional[Histogram], width: int = 420,
                  height: int = 180, mini: bool = False) -> str:
    """Render (counts, edges) as a self-contained <svg> fragment."""
    if hist is None:
        return ""
    counts, edges = hist
    counts = np.asarray(counts, dtype=np.float64)
    nbins = counts.size
    if nbins == 0:
        return ""
    if mini:
        width, height = 140, 44
    pad_x, pad_y = (2, 2) if mini else (8, 18)
    plot_w, plot_h = width - 2 * pad_x, height - 2 * pad_y
    peak = counts.max()
    scale = plot_h / peak if peak > 0 else 0.0
    bar_w = plot_w / nbins

    parts = [
        f'<svg class="{"mini-histogram" if mini else "histogram"}" '
        f'viewBox="0 0 {width} {height}" width="{width}" height="{height}" '
        f'xmlns="http://www.w3.org/2000/svg" role="img">'
    ]
    for i, c in enumerate(counts):
        h = c * scale
        x = pad_x + i * bar_w
        y = pad_y + (plot_h - h)
        title = (f"[{fmt_number(float(edges[i]))}, "
                 f"{fmt_number(float(edges[i + 1]))}): {int(c):,}")
        parts.append(
            f'<rect x="{x:.2f}" y="{y:.2f}" width="{max(bar_w - 1, 0.5):.2f}" '
            f'height="{max(h, 0):.2f}" class="hist-bar">'
            f"<title>{title}</title></rect>")
    if not mini:
        # min / max tick labels along the baseline (the reference's full
        # histogram had labeled axes; two anchors keep the SVG tiny)
        base = height - 4
        parts.append(
            f'<text x="{pad_x}" y="{base}" class="hist-label">'
            f"{fmt_number(float(edges[0]))}</text>")
        parts.append(
            f'<text x="{width - pad_x}" y="{base}" text-anchor="end" '
            f'class="hist-label">{fmt_number(float(edges[-1]))}</text>')
    parts.append("</svg>")
    return "".join(parts)


def bar_svg(fraction: float, width: int = 120, height: int = 12) -> str:
    """A proportion bar for frequency tables (reference: the freq-table bar
    column rendered via CSS width in the upstream templates)."""
    fraction = 0.0 if not np.isfinite(fraction) else min(max(fraction, 0.0), 1.0)
    return (
        f'<svg class="freq-bar" viewBox="0 0 {width} {height}" '
        f'width="{width}" height="{height}" '
        f'xmlns="http://www.w3.org/2000/svg">'
        f'<rect x="0" y="0" width="{width}" height="{height}" class="freq-bg"/>'
        f'<rect x="0" y="0" width="{fraction * width:.1f}" height="{height}" '
        f'class="freq-fill"/></svg>')


def corr_cell_style(rho: float) -> str:
    """Background for a correlation-matrix cell: white at 0 through brand
    blue (positive) or red (negative) at |rho|=1."""
    if not np.isfinite(rho):
        return ""
    alpha = abs(float(rho))
    color = "47, 111, 235" if rho >= 0 else "204, 62, 68"
    return f"background-color: rgba({color}, {alpha:.3f});"
