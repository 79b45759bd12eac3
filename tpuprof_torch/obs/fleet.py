"""Fleet-wide metric aggregation, the host half (OBSERVABILITY.md "fleet
view").

Counterpart of ``tpuprof/obs/fleet.py``.  Every process's registry wire
(``MetricsRegistry.to_wire()``) reaches rank 0 through the gloo gather of
``runtime/distributed.publish_fleet``, which hands them to
:func:`write_fleet` (gauges labelled ``host="<rank>"``); a single process
publishes a fleet of one the same way.  An elastic fleet's wires ride its
shared directory keyed by member id (``runtime/fleet.FleetMember.publish``)
into :func:`write_fleet_labeled`.  Either writes
``<metrics_path>.fleet.prom`` and emits a ``fleet_snapshot`` event.

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


def write_fleet_labeled(metrics_path: Optional[str],
                        wires_by_host: Dict[str, Dict[str, Any]],
                        reason: str = "collect") -> Optional[str]:
    """:func:`write_fleet` for wires keyed by a stable member id (an
    elastic fleet's), so the ``host=`` labels survive membership churn: a
    survivor's dump still names a dead member's series by its id."""
    merged = metrics.MetricsRegistry(enabled=True)
    for host in sorted(wires_by_host):
        merged.merge_wire(wires_by_host[host], host=host)
    snap = merged.snapshot()
    events.emit("fleet_snapshot", reason=reason,
                hosts=len(wires_by_host), snapshot=snap)
    if not metrics_path:
        return None
    path = fleet_prom_path(metrics_path)
    try:
        _atomic_text_write(path, merged.render_text())
    except OSError:
        return None         # the fleet dump must never fail the profile
    return path


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
