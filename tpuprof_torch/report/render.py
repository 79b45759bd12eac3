"""stats dict -> HTML.

Copy of ``tpuprof/report/render.py`` over a copy of its templates
(``tpuprof_torch/report/templates``): for the same stats dict and config
the port renders the same bytes as the reference, version string aside.
The footer's scan line reads ``stats["_phases"]``
(``tpuprof_torch/obs/spans.py``) and the degraded-run banner
``stats["_quarantine"]``, which only a run that skipped batches carries
(``runtime/guard.py``).  The reference's pipeline-stats line
(``stats["_obs"]``) waits for the telemetry slice: the port writes no such
key, so it renders nothing, as the reference's does with metrics off.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import jinja2
from markupsafe import Markup

from tpuprof_torch.report import formatters, svg

_TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "templates")


def _alert_if(value, threshold) -> str:
    return formatters.alert_class(value, threshold)


def _abs_alert_if(value, threshold) -> str:
    try:
        return formatters.alert_class(abs(float(value)), threshold)
    except (TypeError, ValueError):
        return ""


def _corr_cell(rho) -> str:
    try:
        return svg.corr_cell_style(float(rho))
    except (TypeError, ValueError):
        return ""


def _env() -> jinja2.Environment:
    env = jinja2.Environment(
        loader=jinja2.FileSystemLoader(_TEMPLATE_DIR),
        autoescape=jinja2.select_autoescape(["html"]),
    )
    env.filters.update({
        "fmt": formatters.fmt_value,
        "pct": formatters.fmt_percent,
        "bytesize": formatters.fmt_bytesize,
        "alert_if": _alert_if,
        "abs_alert_if": _abs_alert_if,
        "histogram_svg": lambda h: Markup(svg.histogram_svg(h)),
        "mini_histogram_svg":
            lambda h: Markup(svg.histogram_svg(h, mini=True)),
        "freq_bar": lambda f: Markup(svg.bar_svg(f)),
        "corr_cell": _corr_cell,
    })
    return env


_ENV = None


def get_env() -> jinja2.Environment:
    """The template environment, built once a process (the drift page
    renders through it too)."""
    global _ENV
    if _ENV is None:
        _ENV = _env()
    return _ENV


def _perf_line(stats: Dict[str, Any]) -> str:
    """The footer's scan line: rows/s over the scan phases and each
    phase's wall seconds from ``stats["_phases"]``; empty when no scan
    phase was timed."""
    phases = stats.get("_phases") or {}
    scan = sum(v for k, v in phases.items() if k.startswith("scan"))
    if not scan:
        return ""
    n = stats["table"]["n"]
    parts = [f"{k} {v:.2f}s" for k, v in sorted(phases.items())]
    return f"{n / scan:,.0f} rows/s · " + " · ".join(parts)


def _quarantine_rows(stats: Dict[str, Any]):
    """The degraded-run manifest for the banner: one row a skipped batch,
    formatted here so the template stays plain.  A clean run has no
    ``_quarantine`` key and renders no banner."""
    rows = []
    for e in stats.get("_quarantine") or []:
        pos = e.get("frag_pos")
        rows.append({
            "site": e.get("site", "?"),
            "cursor": "—" if e.get("cursor") is None else e["cursor"],
            "rows": "?" if e.get("rows") is None else f"{e['rows']:,}",
            "pos": f"frag {pos[0]} batch {pos[1]}" if pos else "—",
            "error": str(e.get("error", ""))[:300],
        })
    return rows


def to_html(stats: Dict[str, Any], config) -> str:
    """The report fragment (reference: ``ProfileReport.html``)."""
    from tpuprof_torch import __version__
    template = get_env().get_template("report.html")
    return template.render(
        table=stats["table"],
        variables=stats["variables"],
        freq=stats["freq"],
        correlations=stats["correlations"],
        messages=stats["messages"],
        sample=stats.get("sample"),
        config=config,
        version=__version__,
        perf=_perf_line(stats),
        pipeline_stats="",
        quarantine=_quarantine_rows(stats),
    )


def to_standalone_html(stats: Dict[str, Any], config,
                       title: str = "tpuprof report") -> str:
    """The fragment inside the standalone page shell (what ``to_file``
    writes)."""
    from tpuprof_torch import __version__
    fragment = to_html(stats, config)
    template = get_env().get_template("base.html")
    return template.render(
        title=title, version=__version__, content=Markup(fragment)).lstrip()
