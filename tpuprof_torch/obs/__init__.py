"""Pipeline observability of the port (OBSERVABILITY.md): the metrics
registry, span tracing, JSONL events, the crash flight recorder, live
progress, memory gauges and the fleet-of-one exposition.

Counterpart of ``tpuprof/obs``, with the same metric names, kinds, label
keys, event kinds and fields.  Off by default, at one branch a site when
off.  Three switches turn it on, strongest first:

* ``ProfilerConfig(metrics_enabled=True, metrics_path=...)``, per run;
* ``--metrics-json PATH`` / ``--progress`` on the command line;
* ``TPUPROF_METRICS=1`` (and ``TPUPROF_METRICS_PATH``) in the environment.

All three land on :func:`configure`, which flips the process-wide registry
and points the JSONL sink.  Host-side and import-light: no torch and no
pandas at import.
"""

from __future__ import annotations

import os
from typing import Optional

from tpuprof_torch.obs import blackbox, events, fleet, memory, metrics
from tpuprof_torch.obs.events import emit, emit_snapshot
from tpuprof_torch.obs.metrics import (MetricsRegistry, counter, enabled,
                                       gauge, histogram, registry,
                                       set_enabled)
from tpuprof_torch.obs.progress import RateEMA, Ticker, registry_progress_line
from tpuprof_torch.obs.spans import current_path, get_phase_report, span

__all__ = [
    "MetricsRegistry", "RateEMA", "Ticker", "blackbox", "block_sample",
    "configure", "configure_from_config", "counter", "current_path",
    "emit", "emit_snapshot", "enabled", "finalize", "fleet", "gauge",
    "get_phase_report", "histogram", "memory", "registry",
    "registry_progress_line", "set_enabled", "snapshot_if_enabled",
    "span",
]

# every Nth device dispatch is timed when > 0 (kernels/fused.py
# observe_dispatch); 0 never synchronizes for telemetry
_block_sample = 0


def block_sample() -> int:
    return _block_sample


def configure(enabled: Optional[bool] = None,
              jsonl_path: Optional[str] = None,
              block_sample: Optional[int] = None,
              max_bytes: Optional[int] = None) -> None:
    """Flip the process-wide observability state.  ``None`` leaves a knob
    as it is, so the CLI and the backend can each set their half."""
    global _block_sample
    if jsonl_path is not None:
        events.set_sink(jsonl_path, max_bytes=max_bytes)
        if enabled is None:     # a sink with recording off would be empty
            enabled = True
    if enabled is not None:
        metrics.set_enabled(enabled)
    if block_sample is not None:
        _block_sample = max(int(block_sample), 0)


def configure_from_config(config) -> None:
    """Apply a ProfilerConfig's metrics fields (the backend calls this at
    the top of a collect, the stream in its constructor)."""
    from tpuprof_torch.config import (resolve_metrics_enabled,
                                      resolve_metrics_max_bytes)
    on = resolve_metrics_enabled(config.metrics_enabled,
                                 config.metrics_path)
    configure(enabled=on, jsonl_path=resolve_metrics_path(config),
              block_sample=config.metrics_block_sample,
              max_bytes=resolve_metrics_max_bytes(config.metrics_max_bytes))
    # the flight recorder's context card: enough to read a postmortem
    # without the process that wrote it
    blackbox.set_context(config_fingerprint=config.fingerprint())


def resolve_metrics_path(config) -> Optional[str]:
    """The JSONL sink path of this config (the field, else
    ``TPUPROF_METRICS_PATH``): also the base of the fleet exposition
    (``<path>.fleet.prom``)."""
    path = config.metrics_path
    if path is None:
        path = os.environ.get("TPUPROF_METRICS_PATH") or None
    return path


def snapshot_if_enabled() -> Optional[dict]:
    """The registry's snapshot when recording is on, else None: what rides
    the stats dict (``stats["_obs"]``) into the report footer."""
    if not metrics.enabled():
        return None
    return metrics.registry().snapshot()


def finalize(reason: str = "final") -> None:
    """Write a final metrics snapshot into the JSONL sink, if any.  The
    sink stays open: a process may profile again and append."""
    if events.get_sink() is not None:
        emit_snapshot(reason=reason)
