"""Reference-layout alias: ``spark_df_profiling.base`` held both halves
of the pipeline in the upstream package (SURVEY.md §1 L2/L3) —
``describe`` (stats collection) and ``to_html`` (rendering).  Counterpart
of the repo's ``spark_df_profiling/base.py``, on the port's equivalents,
which keep the same contracts."""

from typing import Any, Dict, Optional

from tpuprof_torch.api import describe


def to_html(sample, stats_object: Dict[str, Any],
            config: Optional[Any] = None) -> str:
    """Reference: ``base.to_html(sample, stats_object)`` — render the
    report fragment from a stats dict (SURVEY §3.1).  ``sample`` is the
    head-rows DataFrame shown in the report's sample section; the port's
    stats dicts already carry one, so pass ``None`` to keep it."""
    from tpuprof_torch.config import ProfilerConfig
    from tpuprof_torch.report.render import to_html as _render
    stats = dict(stats_object)
    if sample is not None:
        stats["sample"] = sample
    return _render(stats, config or ProfilerConfig())


__all__ = ["describe", "to_html"]
