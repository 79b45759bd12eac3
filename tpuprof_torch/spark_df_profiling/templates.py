"""Reference-layout alias: ``spark_df_profiling.templates.template(name)``
returned a compiled Jinja2 template in the upstream package (SURVEY.md
§2.1 Templates row — ``templates.py`` + ``templates/*.html``).
Counterpart of the repo's ``spark_df_profiling/templates.py``: the port
keeps the same per-section template names (``base.html``,
``report.html``, ``row_num.html``, ``row_cat.html``, ...) in its own
environment (``report/render.get_env``), so the loader maps straight
through."""

from tpuprof_torch.report.render import get_env


def template(template_name: str):
    """Return the compiled Jinja2 template for ``template_name``
    (``.html`` appended when omitted, matching the upstream's loader
    convenience)."""
    name = template_name if template_name.endswith(".html") \
        else template_name + ".html"
    return get_env().get_template(name)


__all__ = ["template"]
