"""``describe`` and ``ProfileReport`` of the PyTorch port, and its
durable-profile entry points ``StreamingProfiler`` and ``resume_profiler``.

Counterpart of ``tpuprof/api.py``.  Statistics are computed eagerly at
construction, on the device given (``None`` = the first CUDA device, which
must exist; the CPU only when asked for with ``device="cpu"``).  Rendering
waits for the first ``.html``; the fragment is cached, so a notebook's
``_repr_html_`` returns the same string every time.
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Optional

from tpuprof_torch.artifact.incremental import resume_profiler
from tpuprof_torch.backends.gpu import GPUStatsBackend
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.runtime.runner import resolve_device
from tpuprof_torch.runtime.stream import StreamingProfiler
from tpuprof_torch.schema import (VariablesView, rejected_variables,
                                  validate_stats)


def _config(config: Optional[ProfilerConfig], kwargs) -> ProfilerConfig:
    if config is not None and kwargs:
        raise ValueError(
            f"pass either an explicit ProfilerConfig or kwargs, not both "
            f"(got config and {sorted(kwargs)})")
    return config or ProfilerConfig.from_kwargs(**kwargs)


def describe(source: Any, config: Optional[ProfilerConfig] = None,
             device=None, **kwargs) -> Dict[str, Any]:
    """The stats dict of ``source`` (a pandas DataFrame, a pyarrow Table
    or Dataset, or the path of a Parquet file or directory), without
    rendering."""
    config = _config(config, kwargs)
    backend = GPUStatsBackend(resolve_device(device))
    stats = backend.collect(source, config)
    problems = validate_stats(stats)
    if problems:
        raise AssertionError(
            f"backend {backend.name!r} violated the stats contract: "
            f"{problems}")
    stats["variables"] = VariablesView(stats["variables"])
    return stats


class ProfileReport:
    """Profile a tabular source and render an HTML report; the statistics
    live in ``.description``."""

    def __init__(self, source: Any, config: Optional[ProfilerConfig] = None,
                 device=None, **kwargs):
        self.config = _config(config, kwargs)
        self.description = describe(source, self.config, device=device)
        self._html: Optional[str] = None

    @property
    def html(self) -> str:
        """The report fragment, rendered once."""
        if self._html is None:
            from tpuprof_torch.report.render import to_html
            self._html = to_html(self.description, self.config)
        return self._html

    def to_file(self, outputfile: str) -> None:
        """Write the standalone HTML page (the fragment in its shell)."""
        from tpuprof_torch.report.render import to_standalone_html
        page = to_standalone_html(self.description, self.config)
        with io.open(outputfile, "w", encoding="utf-8") as fh:
            fh.write(page)

    def to_json_dict(self) -> Dict[str, Any]:
        """The whole stats dict as a ``json.dump``-ready
        ``tpuprof-stats-v1`` structure (what ``--stats-json`` writes)."""
        from tpuprof_torch.report.export import stats_to_json
        return stats_to_json(self.description)

    def get_rejected_variables(self, threshold: Optional[float] = None
                               ) -> List[str]:
        """Columns rejected for high correlation (reads the cached dict)."""
        return rejected_variables(self.description, threshold)

    def _repr_html_(self) -> str:
        return self.html

    def __repr__(self) -> str:
        table = self.description["table"]
        return (f"<tpuprof_torch.ProfileReport n={table['n']} "
                f"nvar={table['nvar']}>")


__all__ = ["ProfileReport", "StreamingProfiler", "describe",
           "resume_profiler"]
