"""Drift dict -> HTML, through the report template environment.

Copy of ``tpuprof/artifact/render.py``: the drift page reuses the profile
report's shell, CSS and filters (``tpuprof_torch/report/render.py``) with
its own fragment template, ``drift.html``.
"""

from __future__ import annotations

from typing import Any, Dict

from markupsafe import Markup


def drift_to_html(drift: Dict[str, Any],
                  title: str = "tpuprof drift report") -> str:
    """Standalone drift page for one ``tpuprof-drift-v1`` dict."""
    from tpuprof_torch import __version__
    from tpuprof_torch.report.render import get_env
    env = get_env()
    fragment = env.get_template("drift.html").render(
        drift=drift, version=__version__)
    return env.get_template("base.html").render(
        title=title, version=__version__,
        content=Markup(fragment)).lstrip()
