"""Always-on crash flight recorder (OBSERVABILITY.md "flight recorder").

Counterpart of ``tpuprof/obs/blackbox.py``: the same ring, context card,
bundle schema (``tpuprof-postmortem-v1``) and environment variables.

The metrics/JSONL layer is opt-in, which means the runs that crash with
telemetry OFF — most of them — leave nothing to debug.  This module is
the black box: a small, lock-cheap ring buffer that records every obs
event (span closes, heartbeats, retries, quarantines, checkpoint
fallbacks, dispatch milestones) whether or not metrics are enabled, plus
a context card (config fingerprint, process index, last checkpoint
cursor, last heartbeat).  When a run dies — a typed error escaping the
CLI, or SIGTERM/SIGUSR1 via the handlers the CLI installs — the ring is
dumped to ``tpuprof-postmortem-<pid>.json`` so every crash leaves a
debuggable artifact.

Cost model: one deque append + dict build per event, at batch/stage
granularity (never per row).  ``TPUPROF_BLACKBOX=0`` disables recording
entirely (one attribute read per site); any other integer sets the ring
capacity (default 512 entries).

Import-light by design: no torch, no pandas — safe from every hot module.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 512
_ENV = "TPUPROF_BLACKBOX"
_ENV_DIR = "TPUPROF_POSTMORTEM_DIR"


def _env_capacity() -> int:
    """``TPUPROF_BLACKBOX``: unset/empty -> default ring; ``0`` ->
    disabled; any other integer -> that capacity."""
    raw = os.environ.get(_ENV)
    if raw in (None, ""):
        return DEFAULT_CAPACITY
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_CAPACITY
    return max(n, 0)


class BlackBox:
    """Bounded in-memory event ring + context card.  Thread-safe; every
    operation is O(1) under one lock (appends never allocate past the
    ring capacity)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(int(capacity), 0)
        self.enabled = self.capacity > 0
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity or 1)
        self._seq = 0
        self._context: Dict[str, Any] = {}

    def record(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        entry = {"seq": 0, "ts": round(time.time(), 3), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)

    def set_context(self, **kv: Any) -> None:
        """Merge facts into the context card dumped with the ring (config
        fingerprint, process index, last checkpoint cursor, ...)."""
        if not self.enabled:
            return
        with self._lock:
            self._context.update(kv)

    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> Dict[str, Any]:
        # dump-time context providers run OUTSIDE the lock (a provider
        # may take its own locks) and
        # inside try/except: a postmortem must never crash on the
        # context it is trying to attach
        provided: Dict[str, Any] = {}
        for provider in list(_providers):
            try:
                extra = provider()
                if isinstance(extra, dict):
                    provided.update(extra)
            except Exception:
                provided["context_provider_error"] = repr(provider)
        with self._lock:
            entries = list(self._ring)
            context = dict(self._context)
        context.update(provided)
        return {
            "capacity": self.capacity,
            "recorded": self._seq,
            "dropped": max(self._seq - len(entries), 0),
            "context": context,
            "entries": entries,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._context.clear()
            self._seq = 0

    def dump(self, path: Optional[str] = None,
             error: Optional[BaseException] = None,
             signal_name: Optional[str] = None,
             reason: str = "crash") -> Optional[str]:
        """Write the postmortem bundle; returns the path written (None
        when disabled or unwritable — a dump must never mask the crash
        it describes)."""
        if not self.enabled:
            return None
        if path is None:
            path = os.path.join(os.environ.get(_ENV_DIR) or os.getcwd(),
                                f"tpuprof-postmortem-{os.getpid()}.json")
        bundle = self.snapshot()
        bundle.update({
            "schema": "tpuprof-postmortem-v1",
            "pid": os.getpid(),
            "ts": round(time.time(), 3),
            "reason": reason,
        })
        if error is not None:
            bundle["error"] = {"type": type(error).__name__,
                               "message": str(error)}
        if signal_name is not None:
            bundle["signal"] = signal_name
        try:
            with open(path, "w") as fh:
                # default=str: numpy scalars / paths / exceptions in ring
                # fields must never make the crash dump itself crash
                json.dump(bundle, fh, default=str, indent=1)
        except OSError:
            return None
        return path


# ---------------------------------------------------------------------------
# process-wide recorder
# ---------------------------------------------------------------------------

_box = BlackBox(_env_capacity())


def box() -> BlackBox:
    return _box


def enabled() -> bool:
    return _box.enabled


def record(kind: str, **fields: Any) -> None:
    _box.record(kind, **fields)


def set_context(**kv: Any) -> None:
    _box.set_context(**kv)


def dump_postmortem(error: Optional[BaseException] = None,
                    signal_name: Optional[str] = None,
                    reason: str = "crash",
                    path: Optional[str] = None) -> Optional[str]:
    return _box.dump(path=path, error=error, signal_name=signal_name,
                     reason=reason)


_providers: List[Any] = []      # dump-time context callables


def register_context_provider(fn) -> None:
    """Attach a callable returning a dict merged into every postmortem's
    context card AT DUMP TIME (so the snapshot is current, not a stale
    periodic copy).
    Providers must be quick and are exception-isolated."""
    if fn not in _providers:
        _providers.append(fn)


def unregister_context_provider(fn) -> None:
    try:
        _providers.remove(fn)
    except ValueError:
        pass


_installed = {"term": None, "usr1": None}   # our live handler objects


def install_signal_handlers() -> bool:
    """CLI entry hook: dump the ring on SIGTERM (then die with the
    default disposition, so wrappers still see a signal death) and on
    SIGUSR1 (dump and keep running — live inspection of a wedged
    process).  Returns False when disabled or not installable (non-main
    thread, platform without the signals).

    Idempotent and daemon-safe: a long-lived process (or a wrapper
    calling per request) installs the handlers exactly
    ONCE — a repeat call that finds OUR handler still registered
    returns True without re-wrapping, so closures never stack and
    ``signal.getsignal`` stays stable for embedders.  If an embedding
    host replaced the dispositions since, the call installs afresh
    (the check is against the live registration, not a sticky flag)."""
    if not _box.enabled:
        return False
    import signal as _signal
    if _installed["term"] is not None \
            and _signal.getsignal(_signal.SIGTERM) is _installed["term"]:
        return True

    def _usr1(signum, frame):
        _box.record("signal", name="SIGUSR1")
        dump_postmortem(signal_name="SIGUSR1", reason="signal")

    def _term(signum, frame):
        _box.record("signal", name="SIGTERM")
        dump_postmortem(signal_name="SIGTERM", reason="signal")
        # restore the default disposition and re-raise so the exit
        # status stays "killed by SIGTERM", not a swallowed signal
        _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
        os.kill(os.getpid(), _signal.SIGTERM)

    try:
        _signal.signal(_signal.SIGTERM, _term)
        if hasattr(_signal, "SIGUSR1"):
            _signal.signal(_signal.SIGUSR1, _usr1)
    except (ValueError, OSError):
        # not the main thread, or an embedding host owns the handlers
        return False
    _installed["term"] = _term
    _installed["usr1"] = _usr1
    return True
