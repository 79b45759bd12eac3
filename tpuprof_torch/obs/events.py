"""JSONL event sink (OBSERVABILITY.md "JSONL events").

Counterpart of ``tpuprof/obs/events.py``: the same event kinds and field
names (the ``EVENT_SCHEMA`` contract of ``tests/test_obs_smoke.py``).

One line per event, append-only, written as it happens so a crashed run
leaves a readable trace up to the crash.  Events are flat dicts with a
``kind`` discriminator:

* ``{"kind": "span", "name", "seconds", "path", "depth", ...meta}`` —
  emitted by obs/spans.py at every span exit
* ``{"kind": "metric", "name", "type", "labels", "value"|"count"/"sum"}``
  — one event per live series, emitted by :func:`emit_snapshot`
  (finalize and the ``--metrics-interval`` ticker)
* ``{"kind": "heartbeat", ...}`` — StreamingProfiler.heartbeat() /
  the CLI ``--progress`` ticker

Every event carries ``ts`` (epoch seconds).  Field values are coerced
via ``default=str`` — numpy scalars, paths and timestamps must never
crash the pipeline they observe.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from tpuprof_torch.obs import blackbox, metrics


class JsonlSink:
    """Thread-safe append-only JSONL writer (line-buffered).

    ``max_bytes`` (config ``metrics_max_bytes`` /
    ``TPUPROF_METRICS_MAX_BYTES``; None/0 = unlimited) caps on-disk
    growth: when the file would exceed the cap it rotates once to
    ``path.1`` (replacing any previous rotation) and keeps appending to
    a fresh ``path`` — a week-long stream's sink is then bounded at
    ~2x max_bytes instead of filling the disk."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = int(max_bytes) if max_bytes else 0
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0

    def _rotate_locked(self) -> None:
        self._fh.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass            # rotation is best-effort; appending resumes
        self._fh = open(self.path, "a", buffering=1)
        self._bytes = 0

    def write(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, default=str) + "\n"
        with self._lock:
            if self._fh.closed:
                return
            if self.max_bytes and self._bytes \
                    and self._bytes + len(line) > self.max_bytes:
                self._rotate_locked()
            self._fh.write(line)
            self._bytes += len(line)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


_lock = threading.Lock()
_sink: Optional[JsonlSink] = None


def set_sink(path: Optional[str],
             max_bytes: Optional[int] = None) -> Optional[JsonlSink]:
    """Point the process-wide sink at ``path`` (None closes it).  A
    repeated call with the sink's current path keeps it (appending,
    updating the growth cap), so configure() is idempotent across
    CLI + backend."""
    global _sink
    with _lock:
        if _sink is not None and (path is None or _sink.path != path):
            _sink.close()
            _sink = None
        if path is not None and _sink is None:
            _sink = JsonlSink(path, max_bytes=max_bytes)
        elif _sink is not None and max_bytes is not None:
            _sink.max_bytes = int(max_bytes) if max_bytes else 0
        return _sink


def get_sink() -> Optional[JsonlSink]:
    return _sink


def emit(kind: str, **fields) -> None:
    """Write one event to the sink, if any — and ALWAYS into the crash
    flight recorder (obs/blackbox.py), so a run with metrics off still
    leaves a ring of recent events behind a crash."""
    blackbox.record(kind, **fields)
    sink = _sink
    if sink is None:
        return
    sink.write({"ts": round(time.time(), 3), "kind": kind, **fields})


def emit_snapshot(registry: Optional[metrics.MetricsRegistry] = None,
                  reason: str = "snapshot") -> None:
    """One ``metric`` event per live series — the JSONL twin of
    ``render_text()`` (same names, same label strings)."""
    sink = _sink
    if sink is None:
        return
    reg = registry if registry is not None else metrics.registry()
    snap = reg.snapshot()
    ts = round(time.time(), 3)
    for mtype, byname in (("counter", snap["counters"]),
                          ("gauge", snap["gauges"])):
        for name, series in byname.items():
            for labels, value in series.items():
                sink.write({"ts": ts, "kind": "metric", "reason": reason,
                            "name": name, "type": mtype,
                            "labels": labels, "value": value})
    for name, series in snap["histograms"].items():
        for labels, st in series.items():
            sink.write({"ts": ts, "kind": "metric", "reason": reason,
                        "name": name, "type": "histogram",
                        "labels": labels, "count": st["count"],
                        "sum": st["sum"], "mean": st["mean"]})
