"""The ingest guard: retry, poison-batch quarantine, watchdogs.

Counterpart of ``tpuprof/runtime/guard.py``, rung by rung:

1. **retry** (:class:`BatchGuard`) — transient errors (``OSError``, Arrow
   IO and decode errors, :class:`TransientError`) on the idempotent
   per-batch prepare are retried ``ingest_retries`` times with exponential
   backoff before anything escalates;
2. **quarantine** (:class:`Quarantine`) — a batch that still fails, or
   whose fold raises (never retried: a partial fold cannot be replayed), is
   skipped: its cursor, row count and error land in the manifest and the
   ``quarantine_log``, and the report shows a degraded-run banner.
   Budgeted by ``max_quarantined``; the default 0 fails fast, so default
   results are unchanged;
3. **watchdog** (:func:`watched`, :class:`Deadline`) — a blocking call runs
   under a deadline and raises :class:`WatchdogTimeout` with a heartbeat
   snapshot instead of hanging.

Each rung counts what it did (``tpuprof_ingest_retries_total``,
``tpuprof_batches_quarantined_total``, ``tpuprof_watchdog_timeouts_total``
by site, ``tpuprof_watchdog_wait_seconds``) and emits its event
(``ingest_retry``, ``batch_quarantined``, ``watchdog_timeout``); a batch
that escalates leaves a ``batch_failed`` entry in the flight recorder.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from tpuprof_torch.errors import (PoisonBatchError, TransientError,
                                  WatchdogTimeout)
from tpuprof_torch.obs import blackbox, events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.testing import faults

_RETRIES = _obs_metrics.counter(
    "tpuprof_ingest_retries_total",
    "transient per-batch failures retried by the ingest guard, by site")
_QUARANTINED = _obs_metrics.counter(
    "tpuprof_batches_quarantined_total",
    "batches skipped by the poison-batch quarantine, by site")
_WATCHDOG_TIMEOUTS = _obs_metrics.counter(
    "tpuprof_watchdog_timeouts_total",
    "watched blocking calls that overran their deadline, by site")
_WATCHDOG_WAIT_SECONDS = _obs_metrics.histogram(
    "tpuprof_watchdog_wait_seconds",
    "wall seconds a watched call actually took (completed calls only)")


def is_transient(exc: BaseException) -> bool:
    """The retryable class: ``OSError`` (and :class:`TransientError` under
    it) plus pyarrow's IO and decode errors."""
    if isinstance(exc, (TransientError, OSError)):
        return True
    import pyarrow as pa
    return isinstance(exc, (pa.ArrowIOError, pa.ArrowInvalid))


class PoisonBatch(NamedTuple):
    """Delivered through the prepare pipeline in place of a batch that
    failed past its retry budget when quarantine is on: the pipeline stays
    alive and ordered, and the consumer decides (:meth:`Quarantine.admit`)
    whether the budget covers the skip."""

    site: str
    error: str
    rows: Optional[int] = None
    frag_pos: Optional[tuple] = None


class BatchGuard:
    """Per-batch retry policy, and poison capture, for the prepare.

    ``capture=True`` turns a batch that keeps failing into a
    :class:`PoisonBatch`; ``capture=False`` (quarantine off) re-raises the
    original error after the retries."""

    def __init__(self, retries: int = 0, backoff_s: float = 0.05,
                 capture: bool = False,
                 sleep: Callable[[float], None] = time.sleep):
        self.retries = max(int(retries), 0)
        self.backoff_s = float(backoff_s)
        self.capture = bool(capture)
        self._sleep = sleep

    def run(self, fn: Callable[[], Any], *, site: str,
            key: Any = None, rows: Optional[int] = None,
            frag_pos: Optional[tuple] = None) -> Any:
        attempt = 0
        while True:
            try:
                faults.hit(site, key=key)
                return fn()
            except Exception as exc:
                if is_transient(exc) and attempt < self.retries:
                    attempt += 1
                    _RETRIES.inc(site=site)
                    events.emit("ingest_retry", site=site, key=key,
                                attempt=attempt,
                                error=f"{type(exc).__name__}: {exc}")
                    if self.backoff_s > 0:
                        self._sleep(self.backoff_s * (2 ** (attempt - 1)))
                    continue
                # the escalation lands in the flight recorder before it
                # raises: a postmortem's last entries name the failing
                # site, metrics on or off
                blackbox.record("batch_failed", site=site, key=key,
                                attempts=attempt + 1,
                                error=f"{type(exc).__name__}: {exc}")
                if self.capture:
                    return PoisonBatch(
                        site=site, error=f"{type(exc).__name__}: {exc}",
                        rows=rows, frag_pos=frag_pos)
                raise


class Quarantine:
    """Bounded skip-list of poison batches.

    ``admit`` records the skip (budget permitting) or raises: the original
    error when quarantine is off (``max_quarantined`` <= 0, fail fast),
    :class:`PoisonBatchError` carrying the manifest when the budget is
    spent."""

    def __init__(self, max_quarantined: int = 0,
                 log_path: Optional[str] = None):
        self.max = int(max_quarantined)
        self.log_path = log_path
        self.entries: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.max > 0

    def admit(self, *, site: str, error: Any, cursor: Optional[int] = None,
              rows: Optional[int] = None,
              frag_pos: Optional[tuple] = None) -> Dict[str, Any]:
        if not self.enabled:
            if isinstance(error, BaseException):
                raise error
            raise PoisonBatchError(
                f"poison batch at {site!r} (cursor={cursor}): {error} "
                "— quarantine is disabled (max_quarantined=0)")
        entry = {
            "site": site, "cursor": cursor, "rows": rows,
            "frag_pos": list(frag_pos) if frag_pos else None,
            "error": error if isinstance(error, str)
            else f"{type(error).__name__}: {error}",
        }
        with self._lock:
            self.entries.append(entry)
            n = len(self.entries)
        _QUARANTINED.inc(site=site)
        events.emit("batch_quarantined", **entry)
        if self.log_path:
            try:
                with open(self.log_path, "a") as fh:
                    fh.write(json.dumps(entry, default=str) + "\n")
            except OSError:
                pass        # the log is best-effort; the manifest rules
        if n > self.max:
            exc = PoisonBatchError(
                f"giving up: {n} batches quarantined, budget "
                f"max_quarantined={self.max} exhausted "
                f"(last: {entry['site']} cursor={cursor}: "
                f"{entry['error']})", manifest=self.entries)
            if isinstance(error, BaseException):
                raise exc from error
            raise exc
        return entry

    def seed(self, entries) -> None:
        """Adopt a restored checkpoint's manifest: a degraded prefix stays
        degraded after a resume."""
        with self._lock:
            self.entries = list(entries or [])


def _expired(site: str, timeout_s: float,
             heartbeat: Optional[Callable[[], Dict[str, Any]]]
             ) -> WatchdogTimeout:
    _WATCHDOG_TIMEOUTS.inc(site=site)
    hb = None
    if heartbeat is not None:
        try:
            hb = heartbeat()
        except Exception:       # a broken heartbeat must not mask the
            hb = None           # timeout it reports on
    events.emit("watchdog_timeout", site=site, timeout_s=timeout_s,
                heartbeat=hb)
    return WatchdogTimeout(site, timeout_s, heartbeat=hb)


class Deadline:
    """A watchdog for polling loops that keep working between checks:
    ``check()`` raises :class:`WatchdogTimeout` once the deadline has
    passed; a ``timeout_s`` of None or 0 never expires."""

    def __init__(self, timeout_s: Optional[float], site: str,
                 heartbeat: Optional[Callable[[], Dict[str, Any]]] = None):
        self.timeout_s = float(timeout_s) if timeout_s else None
        self.site = site
        self.heartbeat = heartbeat
        self._t0 = time.monotonic()

    def check(self) -> None:
        if self.timeout_s is None:
            return
        if time.monotonic() - self._t0 <= self.timeout_s:
            return
        raise _expired(self.site, self.timeout_s, self.heartbeat)


def watched(fn: Callable[[], Any], timeout_s: Optional[float], site: str,
            heartbeat: Optional[Callable[[], Dict[str, Any]]] = None
            ) -> Any:
    """Run ``fn`` under a deadline.  ``timeout_s`` None or 0 calls it
    directly.  On expiry the worker thread is abandoned (a daemon; the
    process is expected to end on :class:`WatchdogTimeout`) and the caller
    gets the timeout with a heartbeat snapshot."""
    if not timeout_s:
        return fn()
    result: List[Any] = []
    err: List[BaseException] = []
    done = threading.Event()

    def _body() -> None:
        try:
            result.append(fn())
        except BaseException as exc:        # noqa: BLE001 — re-raised
            err.append(exc)
        finally:
            done.set()

    t0 = time.perf_counter()
    threading.Thread(target=_body, daemon=True,
                     name=f"tpuprof-torch-watchdog-{site}").start()
    if not done.wait(timeout_s):
        raise _expired(site, float(timeout_s), heartbeat)
    _WATCHDOG_WAIT_SECONDS.observe(time.perf_counter() - t0, site=site)
    if err:
        raise err[0]
    return result[0]
