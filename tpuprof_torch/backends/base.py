"""The StatsBackend protocol and the port's backend registry.

Counterpart of ``tpuprof/backends/base.py``: one method,
``collect(source, config) -> stats dict``, so engines are interchangeable
and the renderer never knows which one ran.

Where the port differs, by design: the reference's ``"auto"`` falls back to
its CPU oracle when no accelerator is visible.  Here ``"auto"`` and
``"tpu"`` always name the port's engine (``GPUStatsBackend``): on
``cuda:0``, raising without a CUDA device, and on the kernels' plain
versions only when the caller asks for ``device="cpu"``.  The exact pandas
oracle (``backends/cpu.py``) runs only when ``"cpu"`` is named — no
fallback hides the device.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable

from tpuprof_torch.backends.cpu import CPUStatsBackend
from tpuprof_torch.backends.gpu import GPUStatsBackend
from tpuprof_torch.config import BACKENDS, ProfilerConfig
from tpuprof_torch.runtime.runner import resolve_device


@runtime_checkable
class StatsBackend(Protocol):
    """An engine that turns a tabular source into the stats dict
    (``tpuprof_torch.schema`` contract)."""

    name: str

    def collect(self, source: Any, config: ProfilerConfig) -> Dict[str, Any]:
        """Profile ``source`` (a pandas DataFrame, a pyarrow Table or
        Dataset, or the path of a Parquet file or directory) and return a
        stats dict that passes ``tpuprof_torch.schema.validate_stats``."""
        ...


def get_backend(name: str, device=None) -> StatsBackend:
    """Resolve a backend by name.  ``"cpu"`` is the oracle and takes no
    device; ``"auto"`` and ``"tpu"`` are the port's engine on ``device``
    (None: the CUDA devices the process sees, at least one of which must
    exist; ``"cpu"``: the kernels' plain versions)."""
    if name == "cpu":
        return CPUStatsBackend()
    if name in BACKENDS:
        # raises without a CUDA device unless the CPU was asked for; with
        # no device named the engine takes every CUDA device it sees
        resolved = resolve_device(device)
        return GPUStatsBackend(resolved if device is not None else None)
    raise ValueError(f"unknown backend {name!r} (expected cpu|tpu|auto)")
