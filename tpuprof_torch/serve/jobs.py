"""Job state machine + bounded admission queue of the port's serve daemon.

Counterpart of ``tpuprof/serve/jobs.py``, the same states, transitions,
admission errors and wire record (:meth:`Job.to_wire`).

A job is one profile request: a source, an output, a tenant, and a dict
of ProfilerConfig overrides.  Its lifecycle is a small explicit state
machine — ``queued -> running -> done|failed`` with ``rejected`` as the
admission-time terminal — because a daemon serving many tenants must
never lose track of what a request is doing, and an illegal transition
(finishing a job that never ran, re-running a finished one) is a
scheduler bug worth crashing on, not papering over.

Admission control is the queue's job: a bounded depth (`serve_queue_depth`)
keeps a burst from buffering unbounded work, and a per-tenant quota
(`serve_tenant_quota`, counting queued+running) keeps one tenant from
starving the rest of the card.  Over-limit submissions REJECT loudly at
admit time — sub-second feedback beats a silently growing backlog.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
REJECTED = "rejected"

TERMINAL = (DONE, FAILED, REJECTED)

_TRANSITIONS = {
    # QUEUED -> FAILED is the never-started terminal: a client deadline
    # that expired in the queue, or a cancellation before any worker
    # claimed the job — the work must not reach the card
    QUEUED: {RUNNING, REJECTED, FAILED},
    RUNNING: {DONE, FAILED},
    DONE: set(),
    FAILED: set(),
    REJECTED: set(),
}

_id_counter = itertools.count()


def new_job_id() -> str:
    """Sortable, collision-free within and across processes:
    nanosecond timestamp + pid + a process-local counter."""
    return f"j{time.time_ns():x}-{os.getpid()}-{next(_id_counter)}"


class Job:
    """One profile request and its lifecycle record."""

    def __init__(self, source: Any, output: Optional[str] = None,
                 tenant: str = "default", job_id: Optional[str] = None,
                 stats_json: Optional[str] = None,
                 artifact: Optional[str] = None,
                 config_kwargs: Optional[Dict[str, Any]] = None,
                 deadline_unix: Optional[float] = None):
        self.id = job_id or new_job_id()
        self.source = source
        self.output = output
        self.tenant = str(tenant)
        self.stats_json = stats_json
        self.artifact = artifact
        self.config_kwargs = dict(config_kwargs or {})
        self.deadline_unix = (float(deadline_unix)
                              if deadline_unix is not None else None)
                                                # client deadline, epoch
                                                # seconds: expired jobs
                                                # are never started
        self.cancelled = False                  # client gone before the
                                                # answer; honored only
                                                # while still QUEUED
        self.state = QUEUED
        self.error: Optional[str] = None
        self.exit_code: Optional[int] = None
        self.reject_kind: Optional[str] = None  # admission-failure class
                                                # name (QueueFull, ...)
                                                # — an HTTP edge's
                                                # status-code hook
        self.result: Dict[str, Any] = {}
        self.enqueued_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.cache_hit: Optional[bool] = None
        self.coalesced_with: Optional[str] = None  # primary job id this
                                                # submit collapsed onto
                                                # (the read tier)
        self.read_cache: Optional[str] = None   # "hit" when the result
                                                # cache answered at
                                                # admission (no queue,
                                                # no card)
        self._config = None          # validated ProfilerConfig (scheduler)
        self._key = None             # read-tier coalescing key (source
                                     # fingerprint, config fingerprint)
        self._followers: List["Job"] = []   # same-key submits riding
                                            # this job's one compute

    def to(self, state: str, error: Optional[str] = None,
           exit_code: Optional[int] = None) -> "Job":
        if state not in _TRANSITIONS.get(self.state, ()):
            raise ValueError(
                f"job {self.id}: illegal transition "
                f"{self.state!r} -> {state!r}")
        self.state = state
        if state == RUNNING:
            self.started_at = time.monotonic()
        if state in TERMINAL:
            self.finished_at = time.monotonic()
        if error is not None:
            self.error = str(error)
        if exit_code is not None:
            self.exit_code = int(exit_code)
        return self

    @property
    def seconds(self) -> Optional[float]:
        """End-to-end latency (enqueue -> terminal) — what the p50/p99
        SLO tracks (queue wait included: a user waits it too)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.enqueued_at

    @property
    def queue_seconds(self) -> Optional[float]:
        if self.started_at is None:
            return None
        return self.started_at - self.enqueued_at

    def to_wire(self) -> Dict[str, Any]:
        """JSON-ready lifecycle record — the result-file body and the
        SIGUSR1 queue snapshot's per-job entry."""
        out = {
            "id": self.id, "tenant": self.tenant, "status": self.state,
            "source": str(self.source), "output": self.output,
        }
        if self.seconds is not None:
            out["seconds"] = round(self.seconds, 4)
        if self.queue_seconds is not None:
            out["queue_seconds"] = round(self.queue_seconds, 4)
        if self.error is not None:
            out["error"] = self.error
        if self.exit_code is not None:
            out["exit_code"] = self.exit_code
        if self.reject_kind is not None:
            out["reject_kind"] = self.reject_kind
        if self.deadline_unix is not None:
            out["deadline_unix_ms"] = int(self.deadline_unix * 1000)
        if self.cancelled:
            out["cancelled"] = True
        if self.cache_hit is not None:
            out["cache_hit"] = self.cache_hit
        if self.coalesced_with is not None:
            out["coalesced_with"] = self.coalesced_with
        if self.read_cache is not None:
            out["read_cache"] = self.read_cache
        out.update(self.result)
        return out


class JobQueue:
    """Bounded FIFO with per-tenant quotas.

    ``admit`` either enqueues or raises :class:`QueueFull`/
    :class:`TenantQuotaExceeded`; a tenant's count covers queued AND
    running jobs (released by :meth:`release`), so a quota of 2 means
    "at most 2 of this tenant's profiles occupy the card or its queue
    at any moment"."""

    def __init__(self, depth: int = 32, tenant_quota: int = 0):
        self.depth = max(int(depth), 1)
        self.tenant_quota = max(int(tenant_quota), 0)   # 0 = unlimited
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._queue: "collections.deque[Job]" = collections.deque()
        self._tenant_live: Dict[str, int] = {}
        self._closed = False

    def admit(self, job: Job) -> None:
        with self._lock:
            if self._closed:
                raise QueueClosed("serve queue is shut down")
            if len(self._queue) >= self.depth:
                raise QueueFull(
                    f"serve queue is full ({self.depth} jobs queued) — "
                    "retry later or raise --serve-queue-depth")
            live = self._tenant_live.get(job.tenant, 0)
            if self.tenant_quota and live >= self.tenant_quota:
                raise TenantQuotaExceeded(
                    f"tenant {job.tenant!r} already has {live} jobs "
                    f"queued or running (quota {self.tenant_quota}) — "
                    "wait for one to finish or raise "
                    "--serve-tenant-quota")
            self._tenant_live[job.tenant] = live + 1
            self._queue.append(job)
            self._not_empty.notify()

    def next(self, timeout: Optional[float] = None) -> Optional[Job]:
        """Pop the oldest queued job; None on timeout or when closed
        with an empty queue (the worker-shutdown signal)."""
        with self._lock:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while not self._queue:
                if self._closed:
                    return None
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            return self._queue.popleft()

    def release(self, job: Job) -> None:
        """A job left the live set (terminal state) — free its tenant
        slot."""
        with self._lock:
            live = self._tenant_live.get(job.tenant, 0)
            if live <= 1:
                self._tenant_live.pop(job.tenant, None)
            else:
                self._tenant_live[job.tenant] = live - 1

    def drain(self, keep=None) -> List[Job]:
        """Graceful-drain helper: pop and return every job
        still waiting in the queue — jobs ``keep(job)`` selects stay
        queued (a closing fleet daemon keeps follower-laden jobs, whose
        local waiters still need the answer HERE)."""
        with self._lock:
            kept: "collections.deque[Job]" = collections.deque()
            out: List[Job] = []
            while self._queue:
                job = self._queue.popleft()
                if keep is not None and keep(job):
                    kept.append(job)
                else:
                    out.append(job)
            self._queue.extend(kept)
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "depth": self.depth,
                "queued": len(self._queue),
                "tenant_quota": self.tenant_quota,
                "tenants_live": dict(self._tenant_live),
                "queued_jobs": [j.id for j in self._queue],
            }


class QueueFull(RuntimeError):
    """Admission rejected: the bounded queue is at depth."""


class BacklogFull(RuntimeError):
    """Admission shed: the queued-compute depth crossed the
    ``serve_backlog`` budget.  Softer than :class:`QueueFull` — the queue
    still has room, the daemon is deliberately degrading to "reads
    only"."""


class TenantQuotaExceeded(RuntimeError):
    """Admission rejected: this tenant's queued+running quota is used."""


class QueueClosed(RuntimeError):
    """Admission rejected: the scheduler is shutting down."""


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile on a small latency list (no numpy on the
    admission path; the scheduler's stats() is host-cheap)."""
    if not values:
        return 0.0
    vs = sorted(values)
    k = min(max(int(round(q / 100.0 * (len(vs) - 1))), 0), len(vs) - 1)
    return vs[k]
