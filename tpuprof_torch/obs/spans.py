"""Phase spans: the wall seconds of each pipeline stage.

Counterpart of ``tpuprof/obs/spans.py`` without its metrics histogram and
event sink (telemetry is a later slice of the port).  ``span("scan_a")``
times its body and adds the seconds, on a lock, to the total of its leaf
name; :func:`get_phase_report` reads (and optionally resets) the totals.
The backend resets them when a profile starts and snapshots them onto the
profile's ``stats["_phases"]`` when it ends; the report footer reads them
from there.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

_lock = threading.Lock()
_phase_totals: Dict[str, float] = {}


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Time a pipeline stage.  Exceptions propagate; the time is recorded
    either way (a failed stage's cost is still cost)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _phase_totals[name] = _phase_totals.get(name, 0.0) + dt


def get_phase_report(reset: bool = False) -> Dict[str, float]:
    """Wall seconds accumulated per span name since the last reset."""
    with _lock:
        out = dict(_phase_totals)
        if reset:
            _phase_totals.clear()
    return out
