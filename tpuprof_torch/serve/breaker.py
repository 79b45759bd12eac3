"""Circuit breaker on the warehouse tier of ``POST /v1/query``.

Counterpart of ``tpuprof/serve/breaker.py``, with the reference's states,
events and metric.  A rotting warehouse chain makes every query pay a walk
over corrupt generations before it falls through to compute.  The breaker
makes that tax one-time: consecutive failed or corrupt generation reads per
source open it, and an open breaker routes queries straight to the compute
tier (the answer labeled ``provenance:"breaker_open"``).  After
``breaker_cooldown_s`` it goes half-open and lets exactly ONE probe back
through the warehouse: a fresh answer closes it, another failure re-opens
it for another cooldown.

States are per source key, transitions are events and metrics
(``breaker_transition`` / ``tpuprof_breaker_transitions_total``), and the
whole thing is process-local: a breaker is a latency shield, not a
correctness gate — the compute tier behind it is always right.  The
process-wide :func:`default_breaker` keeps its state across edges, so
tests call :func:`reset_default`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_TRANSITIONS = _obs_metrics.counter(
    "tpuprof_breaker_transitions_total",
    "warehouse-pushdown circuit-breaker state transitions by the state "
    "entered (open = a source's warehouse reads keep failing, queries "
    "detour to compute; half_open = one probe allowed; closed = the "
    "probe answered, the warehouse is trusted again)")


class _State:
    __slots__ = ("state", "failures", "opened_at", "probing")

    def __init__(self) -> None:
        self.state = CLOSED
        self.failures = 0            # consecutive, reset on any success
        self.opened_at = 0.0
        self.probing = False         # a half-open probe is in flight


class CircuitBreaker:
    """Per-key consecutive-failure breaker (closed/open/half-open)."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._lock = threading.Lock()
        self._states: Dict[str, _State] = {}

    def _transition(self, key: str, st: _State, state: str) -> None:
        st.state = state
        if _obs_metrics.enabled():
            _TRANSITIONS.inc(state=state)
            _obs_events.emit("breaker_transition", source=key,
                             state=state, failures=st.failures)

    def allow(self, key: str) -> bool:
        """May a warehouse read for ``key`` proceed?  Open -> no (skip
        to compute).  Half-open admits exactly one probe per cooldown
        window; concurrent queries during the probe stay on compute."""
        with self._lock:
            st = self._states.get(key)
            if st is None or st.state == CLOSED:
                return True
            if st.state == OPEN \
                    and time.monotonic() - st.opened_at >= self.cooldown_s:
                self._transition(key, st, HALF_OPEN)
            if st.state == HALF_OPEN and not st.probing:
                st.probing = True
                return True
            return False

    def record_success(self, key: str) -> None:
        with self._lock:
            st = self._states.get(key)
            if st is None:
                return
            st.failures = 0
            st.probing = False
            if st.state != CLOSED:
                self._transition(key, st, CLOSED)

    def record_failure(self, key: str) -> None:
        with self._lock:
            st = self._states.setdefault(key, _State())
            st.failures += 1
            st.probing = False
            if st.state == HALF_OPEN \
                    or (st.state == CLOSED
                        and st.failures >= self.threshold):
                st.opened_at = time.monotonic()
                self._transition(key, st, OPEN)
            elif st.state == OPEN:
                # a failure while open (racing walker): push the
                # cooldown out — the source is still rotten
                st.opened_at = time.monotonic()

    def state(self, key: str) -> str:
        with self._lock:
            st = self._states.get(key)
            return st.state if st is not None else CLOSED

    def snapshot(self) -> Dict[str, Any]:
        """Healthz view: every non-closed source plus totals."""
        with self._lock:
            open_keys = {k: {"state": s.state, "failures": s.failures}
                         for k, s in self._states.items()
                         if s.state != CLOSED}
            return {"tracked": len(self._states),
                    "open": open_keys}


_default: Optional[CircuitBreaker] = None
_default_lock = threading.Lock()


def default_breaker() -> CircuitBreaker:
    """The process-wide breaker the HTTP edge consults when the daemon
    did not build its own (library embeddings, tests)."""
    global _default
    with _default_lock:
        if _default is None:
            from tpuprof_torch.config import (resolve_breaker_cooldown,
                                        resolve_breaker_threshold)
            _default = CircuitBreaker(
                threshold=resolve_breaker_threshold(),
                cooldown_s=resolve_breaker_cooldown())
        return _default


def reset_default() -> None:
    """Test hook: forget the process-wide breaker's state."""
    global _default
    with _default_lock:
        _default = None
