"""Fleet-wide metric aggregation, the host half (OBSERVABILITY.md "fleet
view").

Counterpart of ``tpuprof/obs/fleet.py`` without the gather across ranks
(``write_fleet_labeled`` and the collective that feeds :func:`write_fleet`
come with the port's multi-GPU slice).  A single process publishes a fleet
of one: the backend hands :func:`write_fleet` its own registry's wire form
(``MetricsRegistry.to_wire()``), which writes ``<metrics_path>.fleet.prom``
and emits a ``fleet_snapshot`` event.

Merge laws (the reference's ``tests/test_fleet.py``):

* counters **sum** across hosts;
* gauges keep **per-host values** under an added ``host=`` label;
* histograms **sum** their bucket ladders (same declared buckets).

Host-side and import-light: no torch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from tpuprof_torch.obs import events, metrics


def _atomic_text_write(path: str, text: str) -> None:
    """Write ``text`` to a dot-prefixed temporary beside ``path``, fsync
    it and rename it over ``path``: a reader racing the write sees the
    previous complete file or the new one, never a torn one."""
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def fleet_prom_path(metrics_path: str) -> str:
    """Where the fleet exposition lands, next to the per-process
    ``<metrics_path>.prom`` twin."""
    return metrics_path + ".fleet.prom"


def merge_wires(wires: List[Dict[str, Any]]) -> metrics.MetricsRegistry:
    """Fold every host's wire into one registry (host i gets gauge label
    ``host="i"``, in list order)."""
    merged = metrics.MetricsRegistry(enabled=True)
    for i, wire in enumerate(wires):
        merged.merge_wire(wire, host=str(i))
    return merged


def write_fleet(metrics_path: Optional[str],
                wires: List[Dict[str, Any]],
                reason: str = "collect",
                quarantined_by_host: Optional[List[int]] = None) -> \
        Optional[str]:
    """Render and persist the fleet view.  Writes
    ``<metrics_path>.fleet.prom`` when a metrics path is configured, and
    emits one ``fleet_snapshot`` event (ring and sink) either way.  Returns
    the path written, or None."""
    merged = merge_wires(wires)
    snap = merged.snapshot()
    events.emit("fleet_snapshot", reason=reason, hosts=len(wires),
                quarantined_by_host=list(quarantined_by_host or []),
                snapshot=snap)
    if not metrics_path:
        return None
    path = fleet_prom_path(metrics_path)
    try:
        _atomic_text_write(path, merged.render_text())
    except OSError:
        return None         # the fleet dump must never fail the profile
    return path
