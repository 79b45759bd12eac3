"""``describe`` and ``ProfileReport`` of the PyTorch port.

Counterpart of ``tpuprof/api.py``.  Statistics are computed eagerly at
construction, on the device given (``None`` = the first CUDA device, which
must exist; the CPU only when asked for with ``device="cpu"``).  HTML
rendering is a later slice of the port: ``.html`` and ``.to_file`` raise
``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from tpuprof_torch.backends.gpu import GPUStatsBackend
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.runtime.runner import resolve_device
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
    """The stats dict of ``source`` (a pandas DataFrame or a pyarrow
    Table), without rendering."""
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
    """Profile a tabular source; the report's statistics live in
    ``.description``."""

    def __init__(self, source: Any, config: Optional[ProfilerConfig] = None,
                 device=None, **kwargs):
        self.config = _config(config, kwargs)
        self.description = describe(source, self.config, device=device)

    @property
    def html(self) -> str:
        raise NotImplementedError(
            "HTML rendering is a later slice of the PyTorch port; the "
            "statistics are in .description")

    def to_file(self, outputfile: str) -> None:
        raise NotImplementedError(
            "HTML rendering is a later slice of the PyTorch port; the "
            "statistics are in .description")

    def get_rejected_variables(self, threshold: Optional[float] = None
                               ) -> List[str]:
        """Columns rejected for high correlation (reads the cached dict)."""
        return rejected_variables(self.description, threshold)

    def __repr__(self) -> str:
        table = self.description["table"]
        return (f"<tpuprof_torch.ProfileReport n={table['n']} "
                f"nvar={table['nvar']}>")
