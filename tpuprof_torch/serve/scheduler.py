"""Request scheduler of the port's serve daemon: the job lifecycle.

Counterpart of ``tpuprof/serve/scheduler.py``.  A long-lived service admits
requests through :class:`ProfileScheduler`: a bounded multi-tenant queue
(``serve/jobs.py``), N worker threads sharing ONE warm card through the
keyed runner cache and the loaded kernel libraries (``serve/cache.py``),
the read tier (a result cache and coalescing of identical submits), and
the telemetry as the SLO layer — request counters by status, a queue-depth
gauge, an end-to-end latency histogram (p50/p99) and a ``serve_job`` JSONL
event per terminal job.

The scheduler runs its jobs on ``resolve_device(device)``: ``cuda:0`` by
default, and it refuses to start without CUDA unless ``device="cpu"`` asks
for the kernels' plain versions.  Each job runs the same
``ProfileReport`` path a one-shot profile runs, so the ingest guard
(retries, quarantine, watchdogs, checkpoints) applies per job, and a typed
failure marks THAT job failed with its CLI exit code while the daemon and
its other tenants keep serving.  Workers launch on the device's current
stream, so two jobs' launches serialize there.  The phase report a profile
returns (``stats["_phases"]``) and the telemetry switches are process-wide,
as in the reference: concurrent jobs' ``_phases`` mix, and a job that says
nothing of metrics keeps the daemon's live metrics state.  SIGUSR1
postmortems include the live queue through the flight recorder's context
provider (``obs/blackbox.py``).
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Any, Dict, List, Optional

from tpuprof_torch.obs import blackbox
from tpuprof_torch.obs import events as _obs_events
from tpuprof_torch.obs import metrics as _obs_metrics
from tpuprof_torch.serve import cache as _cache
from tpuprof_torch.serve.jobs import (DONE, FAILED, QUEUED, REJECTED,
                                      RUNNING, TERMINAL, BacklogFull, Job,
                                      JobQueue, QueueClosed, QueueFull,
                                      TenantQuotaExceeded, percentile)

_REQUESTS = _obs_metrics.counter(
    "tpuprof_serve_requests_total",
    "profile requests by terminal status (done|failed|rejected)")
_QUEUE_DEPTH = _obs_metrics.gauge(
    "tpuprof_serve_queue_depth",
    "jobs waiting in the serve admission queue")
_ACTIVE = _obs_metrics.gauge(
    "tpuprof_serve_active_jobs", "jobs currently profiling on the mesh")
_JOB_SECONDS = _obs_metrics.histogram(
    "tpuprof_serve_job_seconds",
    "end-to-end job latency (enqueue -> terminal), queue wait included "
    "— the p50/p99 SLO series")
_COALESCED = _obs_metrics.counter(
    "tpuprof_coalesced_jobs_total",
    "submits that collapsed onto an in-flight same-key job (read tier "
    "— exactly-once compute, N fanned-out results)")
_SHED = _obs_metrics.counter(
    "tpuprof_requests_shed_total",
    "non-cacheable submits shed at admission because the queued-compute "
    "depth crossed serve_backlog (HTTP 503 + jittered Retry-After) — "
    "overload degrading to reads-only, by design")
_DEADLINE_EXPIRED = _obs_metrics.counter(
    "tpuprof_deadline_expired_total",
    "queued jobs whose client deadline (X-Tpuprof-Deadline-Ms / "
    "--deadline-ms) expired before a worker reached them — never "
    "started, failed with DeadlineExceededError (exit 11)")


class ProfileScheduler:
    """N worker threads draining a bounded multi-tenant job queue on one
    device (``resolve_device(device)``: ``cuda:0`` unless ``"cpu"`` is
    asked for)."""

    def __init__(self, workers: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 job_timeout_s: Optional[float] = None,
                 aot_cache_dir: Optional[str] = None,
                 read_cache: Optional[str] = None,
                 read_cache_entries: Optional[int] = None,
                 read_cache_bytes: Optional[int] = None,
                 serve_backlog: Optional[int] = None,
                 device=None):
        from tpuprof_torch.config import (resolve_aot_cache_dir,
                                    resolve_job_timeout,
                                    resolve_read_cache,
                                    resolve_read_cache_bytes,
                                    resolve_read_cache_entries,
                                    resolve_serve_backlog,
                                    resolve_serve_queue_depth,
                                    resolve_serve_tenant_quota,
                                    resolve_serve_workers)
        from tpuprof_torch.runtime.runner import resolve_device
        # raises without CUDA unless the CPU was asked for: a daemon never
        # carries on on the CPU
        self.device = resolve_device(device)
        self.workers = resolve_serve_workers(workers)
        # overload shed budget: 0 = off — only the hard
        # queue-depth 429 bound applies, the historical behavior
        self.serve_backlog = resolve_serve_backlog(serve_backlog)
        # the read tier is OPT-IN at this layer: a scheduler that was not
        # handed a read_cache mode keeps the every-submit-computes
        # behavior; the serve verb resolves the product default ("on")
        self.read_cache = None
        if read_cache is not None \
                and resolve_read_cache(read_cache) == "on":
            self.read_cache = _cache.ResultCache(
                resolve_read_cache_entries(read_cache_entries),
                resolve_read_cache_bytes(read_cache_bytes))
        # the daemon's store of built kernel libraries (runtime/aot.py): a
        # job that says nothing about its own store inherits it, so every
        # job's runner key feeds the same restart-to-warm store; a job's
        # explicit aot_* fields win
        self.aot_cache_dir = resolve_aot_cache_dir(aot_cache_dir)
        # daemon-level default for jobs that say nothing about their
        # own timeout; a job's explicit job_timeout_s override wins
        self.job_timeout_s = resolve_job_timeout(job_timeout_s)
        self._queue = JobQueue(resolve_serve_queue_depth(queue_depth),
                               resolve_serve_tenant_quota(tenant_quota))
        self._lock = threading.Lock()
        self._done_cond = threading.Condition(self._lock)
        self._jobs: Dict[str, Job] = {}
        self._active: Dict[str, Job] = {}
        self._by_key: Dict[Any, Job] = {}   # in-flight coalescing table:
                                            # (source fp, config fp) ->
                                            # the one computing primary
        self._computed = 0          # jobs that actually ran on the card
        self._coalesced = 0         # submits that rode another's compute
        self._shed = 0              # submits shed past serve_backlog
        self._deadline_expired = 0  # queued jobs dead before a worker
        self._cancelled = 0         # client-disconnect cancellations
        self._released = 0          # drain handoffs to fleet peers
        self._counts = {DONE: 0, FAILED: 0, REJECTED: 0}
        self._latencies: "collections.deque[float]" = \
            collections.deque(maxlen=4096)   # done jobs only (SLO view)
        self._submitted = 0
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"tpuprof-serve-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()
        # SIGUSR1 postmortems carry the live queue: the provider is
        # invoked at DUMP time, so the snapshot is current
        self._context_provider = lambda: {"serve_queue": self.snapshot()}
        blackbox.register_context_provider(self._context_provider)

    # -- admission ---------------------------------------------------------

    def submit(self, job: Optional[Job] = None, **kwargs) -> Job:
        """Admit one job (a prebuilt :class:`Job` or its kwargs).
        Admission failures — full queue, tenant over quota, an invalid
        config — return the job in the ``rejected`` state with the
        reason on ``job.error``; they never raise, because a service
        answers requests, it does not crash on them."""
        if job is None:
            job = Job(**kwargs)
        try:
            job._config = self._build_config(job)
            # the read tier: a side-effect-free repeat answers
            # from the result cache, and a concurrent same-key submit
            # rides the in-flight compute — neither touches the queue
            key = self._coalesce_key(job)
            if key is not None:
                if self._attach_follower(key, job):
                    return job
                hit = self.read_cache.get(key)
                if hit is not None:
                    return self._answer_from_cache(job, hit[0])
                # the probe missed: claim the primary slot atomically
                # with a re-check, so K racing submits elect exactly
                # one computer (the rest attach)
                with self._lock:
                    primary = self._by_key.get(key)
                    if primary is not None \
                            and primary.state not in TERMINAL:
                        return self._attach_locked(primary, key, job)
                    self._by_key[key] = job
                    job._key = key
            # overload shed: past the backlog budget a
            # non-cacheable submit is refused BEFORE the queue — the
            # cache-hit and coalescing returns above never reach here,
            # so the read tier keeps answering while compute degrades
            if self.serve_backlog \
                    and len(self._queue) >= self.serve_backlog:
                raise BacklogFull(
                    f"serve backlog budget exhausted "
                    f"({len(self._queue)} queued >= serve_backlog="
                    f"{self.serve_backlog}) — compute admission is "
                    "shedding while reads keep serving; retry after "
                    "the drain")
            self._queue.admit(job)
        except (QueueFull, TenantQuotaExceeded, QueueClosed,
                BacklogFull, ValueError, TypeError,
                NotImplementedError) as exc:
            # the admission hook: job.reject_kind names the class
            # (quota/depth, a closing queue, a shed, or the request's
            # own fault — an unknown option, a field of a later slice)
            if isinstance(exc, BacklogFull):
                with self._lock:
                    self._shed += 1
                _SHED.inc()
            job.reject_kind = type(exc).__name__
            job.to(REJECTED, error=str(exc))
            with self._lock:
                self._submitted += 1
                self._jobs[job.id] = job
                self._counts[REJECTED] += 1
                if job._key is not None \
                        and self._by_key.get(job._key) is job:
                    del self._by_key[job._key]
            self._record_terminal(job)
            # a follower that attached in the claim->admit window must
            # not wait on a job that will never run
            self._fan_out(job)
            return job
        with self._lock:
            self._submitted += 1
            self._jobs[job.id] = job
        _QUEUE_DEPTH.set(len(self._queue))
        return job

    def _coalesce_key(self, job: Job):
        """The read-tier identity of a submit — or None when the tier
        is off or the job has side effects.  A job that writes an
        output/report/artifact must RUN (the write IS the product);
        only pure "profile and answer" submits are cacheable and
        coalescible."""
        if self.read_cache is None:
            return None
        if job.output or job.stats_json or job.artifact \
                or job.config_kwargs.get("artifact_path"):
            return None
        return (_cache.source_fingerprint(job.source),
                job._config.fingerprint())

    def _attach_follower(self, key, job: Job) -> bool:
        with self._lock:
            primary = self._by_key.get(key)
            if primary is None or primary.state in TERMINAL:
                return False
            self._attach_locked(primary, key, job)
            return True

    def _attach_locked(self, primary: Job, key, job: Job) -> Job:
        primary._followers.append(job)
        job.coalesced_with = primary.id
        job._key = key
        self._submitted += 1
        self._jobs[job.id] = job
        self._coalesced += 1
        _COALESCED.inc()
        return job

    def _answer_from_cache(self, job: Job, payload: bytes) -> Job:
        """Terminal bookkeeping for a result-cache hit: the job never
        queues, never runs, never touches a tenant slot — it is DONE at
        admission with the cached answer."""
        job.read_cache = "hit"
        job.result = dict(json.loads(payload.decode()))
        job.to(RUNNING)
        job.to(DONE)
        with self._done_cond:
            self._submitted += 1
            self._jobs[job.id] = job
            self._counts[DONE] += 1
            if job.seconds is not None:
                self._latencies.append(job.seconds)
            self._done_cond.notify_all()
        self._record_terminal(job)
        return job

    def _fan_out(self, job: Job) -> None:
        """Copy the primary's terminal state onto every follower that
        coalesced onto it — N byte-identical answers from one compute.
        Runs after the primary's own terminal bookkeeping; each
        follower gets its own terminal record/event."""
        while True:
            with self._done_cond:
                if not job._followers:
                    return
                followers = job._followers[:]
                del job._followers[:len(followers)]
            for f in followers:
                f.cache_hit = job.cache_hit
                f.to(RUNNING)
                if job.state == DONE:
                    f.result = dict(job.result)
                    f.to(DONE)
                else:
                    f.to(FAILED, error=job.error,
                         exit_code=job.exit_code)
                with self._done_cond:
                    self._counts[f.state] += 1
                    if f.state == DONE and f.seconds is not None:
                        self._latencies.append(f.seconds)
                    self._done_cond.notify_all()
                self._record_terminal(f)

    def _build_config(self, job: Job):
        """Validate the job's config overrides NOW (admission time):
        a typo'd option must reject in milliseconds, not fail a queued
        job minutes later.  Unknown keys reject explicitly — the
        from_kwargs ignore-unknowns tolerance is a library nicety, but
        a service silently dropping an option would profile the wrong
        thing with a straight face."""
        import dataclasses

        from tpuprof_torch.config import ProfilerConfig
        kwargs = dict(job.config_kwargs)
        # the reference's clients name its accelerator engine "tpu": here
        # that is this engine, so their jobs run
        backend = kwargs.pop("backend", "tpu")
        if backend not in ("tpu", "gpu"):
            raise ValueError(
                f"serve jobs run the gpu engine (got backend="
                f"{backend!r}): the warm runners and loaded kernel "
                "libraries ARE the service; the cpu oracle has nothing to "
                "keep warm")
        known = {f.name for f in dataclasses.fields(ProfilerConfig)}
        unknown = sorted(set(kwargs) - known)
        if unknown:
            raise ValueError(f"unknown config options {unknown}")
        if job.artifact:
            kwargs.setdefault("artifact_path", job.artifact)
        if self.job_timeout_s is not None:
            # every job inherits the daemon's watchdog unless it names
            # its own deadline
            kwargs.setdefault("job_timeout_s", self.job_timeout_s)
        if self.aot_cache_dir is not None:
            # the same inheritance for the store of built libraries: the
            # runner key ignores the aot_* fields, so this changes which
            # store warms the build, never which runner answers the job
            kwargs.setdefault("aot_cache_dir", self.aot_cache_dir)
        if "metrics_enabled" not in kwargs:
            # collect() applies each config's obs knobs PROCESS-WIDE
            # (one-shot CLI semantics); a job that says nothing about
            # metrics must inherit the daemon's live state, not switch
            # the daemon's own SLO counters off mid-serve
            if _obs_metrics.enabled():
                kwargs["metrics_enabled"] = True
        return ProfilerConfig(**kwargs)

    # -- worker loop -------------------------------------------------------

    def _worker(self) -> None:
        while True:
            job = self._queue.next(timeout=0.5)
            if job is None:
                if self._closed and not len(self._queue):
                    return
                continue
            _QUEUE_DEPTH.set(len(self._queue))
            self._run_job(job)

    def _run_job(self, job: Job) -> None:
        import time as _time

        from tpuprof_torch.errors import (TYPED_ERRORS,
                                          DeadlineExceededError, exit_code)
        # never start a dead job: a cancelled submit (client gone, nobody
        # coalesced onto it) or an expired client deadline terminates
        # here, before any device time is spent.  A job with
        # followers runs regardless — someone still wants the answer.
        with self._lock:
            has_followers = bool(job._followers)
        if job.cancelled and not has_followers:
            self._terminate_unstarted(
                job, "cancelled: client disconnected before the answer",
                1)
            return
        if job.deadline_unix is not None and not has_followers:
            late = _time.time() - job.deadline_unix
            if late > 0:
                exc = DeadlineExceededError(job.id, late)
                with self._lock:
                    self._deadline_expired += 1
                _DEADLINE_EXPIRED.inc()
                self._terminate_unstarted(
                    job, f"{type(exc).__name__}: {exc}", exit_code(exc))
                return
        config = job._config
        with self._lock:
            self._computed += 1     # actual runs on the card — the
                                    # read tier's exactly-once witness
        # was this shape's runner already cached? (probe only — the hit
        # itself is counted inside collect's acquire)
        job.cache_hit = self._probe_cache(job, config)
        job.to(RUNNING)
        with self._lock:
            self._active[job.id] = job
        _ACTIVE.inc()
        try:
            def _body() -> None:
                from tpuprof_torch.testing import faults as _faults
                _faults.hit("serve_job", key=job.id)
                from tpuprof_torch.api import ProfileReport
                report = ProfileReport(job.source, config=config,
                                       device=self.device)
                if job.output:
                    report.to_file(job.output)
                if job.stats_json:
                    with open(job.stats_json, "w") as fh:
                        json.dump(report.to_json_dict(), fh, indent=2)
                if config.artifact_path:
                    from tpuprof_torch.artifact import write_artifact
                    write_artifact(config.artifact_path,
                                   stats=report.description,
                                   config=config, source=str(job.source))
                table = report.description["table"]
                job.result = {"rows": int(table["n"]),
                              "cols": int(table["nvar"])}

            # per-job watchdog: a hung profile raises WatchdogTimeout —
            # THIS job fails with exit code 4 and the worker is freed (the
            # body thread is abandoned: its launches still run on the
            # card, on the same stream as the next job's), instead of
            # wedging the daemon.  With no timeout the body runs
            # unwrapped.
            from tpuprof_torch.config import resolve_job_timeout
            from tpuprof_torch.runtime import guard
            guard.watched(
                _body, resolve_job_timeout(config.job_timeout_s),
                site="serve_job",
                heartbeat=lambda: {"job": job.id, "tenant": job.tenant,
                                   "source": str(job.source)})
            job.to(DONE)
        except TYPED_ERRORS as exc:
            # the degradation ladder ran out for THIS job: it fails
            # with its one-shot CLI exit code, the daemon keeps serving
            job.to(FAILED, error=f"{type(exc).__name__}: {exc}",
                   exit_code=exit_code(exc))
            blackbox.dump_postmortem(error=exc, reason="serve_job")
        except Exception as exc:   # noqa: BLE001 — a service survives
            job.to(FAILED, error=f"{type(exc).__name__}: {exc}",
                   exit_code=1)
            blackbox.record("serve_job_crash", job=job.id,
                            error=repr(exc))
        finally:
            _ACTIVE.dec()
            self._queue.release(job)
            if job._key is not None and job.state == DONE \
                    and self.read_cache is not None:
                # publish BEFORE the key leaves the coalescing table:
                # a racing same-key submit either attaches (pre-
                # terminal), or finds the cache warm — never a third
                # compute in the handoff window
                self.read_cache.put(job._key, job.result)
            with self._done_cond:
                self._active.pop(job.id, None)
                self._counts[job.state] += 1
                if job.state == DONE and job.seconds is not None:
                    self._latencies.append(job.seconds)
                if job._key is not None \
                        and self._by_key.get(job._key) is job:
                    del self._by_key[job._key]
                self._done_cond.notify_all()
            self._record_terminal(job)
            self._fan_out(job)

    def _terminate_unstarted(self, job: Job, error: str,
                             code: int) -> None:
        """Terminal bookkeeping for a QUEUED job that must not run
        (expired deadline, cancellation): the queued->failed edge, the
        tenant slot released, the coalescing key freed, followers (if
        any raced in) fanned the failure."""
        job.to(FAILED, error=error, exit_code=code)
        self._queue.release(job)
        with self._done_cond:
            self._counts[FAILED] += 1
            if job._key is not None \
                    and self._by_key.get(job._key) is job:
                del self._by_key[job._key]
            self._done_cond.notify_all()
        self._record_terminal(job)
        self._fan_out(job)

    def cancel(self, job_id: str) -> bool:
        """Client-disconnect cancellation: mark a still-
        QUEUED job so the worker skips it.  Returns False — and leaves
        the job alone — once it is running/terminal or has coalesced
        followers riding it (their answer still matters); a running
        job finishes and publishes to the result cache either way."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state != QUEUED or job._followers:
                return False
            job.cancelled = True
            self._cancelled += 1
        return True

    def release_queued(self, select=None) -> List[Job]:
        """Graceful drain: pull still-QUEUED jobs back out
        of the local queue so a closing fleet daemon's peers can steal
        and answer them (the daemon unlinks the spool claims).  Only
        jobs ``select(job)`` picks are released (the daemon passes its
        spool-backed set — a job with no job file has no peer, so it
        must drain HERE); jobs carrying coalesced
        followers stay queued regardless — a local waiter still needs
        their answer from THIS process.  Released jobs keep their
        QUEUED state and get no terminal record here: their job files
        remain in the spool, and the peer that wins the re-claim
        writes the one result."""
        released = self._queue.drain(
            keep=lambda j: bool(j._followers)
            or (select is not None and not select(j)))
        with self._lock:
            for job in released:
                self._jobs.pop(job.id, None)
                if job._key is not None \
                        and self._by_key.get(job._key) is job:
                    del self._by_key[job._key]
            self._released += len(released)
        for job in released:
            self._queue.release(job)
        return released

    def retry_after_s(self) -> float:
        """Shed-response backoff hint: queued depth over the observed
        drain rate (workers x recent p50), jittered so a thousand shed
        clients do not retry in lockstep (the poll_intervals idiom)."""
        import random
        with self._lock:
            lat: List[float] = list(self._latencies)
            depth = len(self._queue)
        per_job = percentile(lat, 50) or 1.0
        base = max(per_job * max(depth, 1) / max(self.workers, 1), 0.5)
        return round(min(base, 300.0) * random.uniform(0.75, 1.25), 2)

    def _probe_cache(self, job: Job, config) -> Optional[bool]:
        """True when the job's (config, shape) key already holds a
        cached runner — i.e. this job builds and loads nothing.  Shape
        discovery needs the source's schema; any failure there returns
        None and lets the real run report the error."""
        if not _cache.cache_enabled():
            return False
        try:
            from tpuprof_torch.ingest.arrow import ArrowIngest
            ingest = ArrowIngest(job.source, config.batch_rows,
                                 columns=config.columns,
                                 nested=config.nested)
            key = _cache.runner_key(config, ingest.plan.n_num,
                                    ingest.plan.n_hash, [self.device])
            return key in _cache.process_cache()
        except Exception:   # noqa: BLE001 — the run reports it
            return None

    def _record_terminal(self, job: Job) -> None:
        _REQUESTS.inc(status=job.state)
        if job.seconds is not None:
            _JOB_SECONDS.observe(job.seconds)
        _obs_events.emit("serve_job", id=job.id, tenant=job.tenant,
                         status=job.state,
                         seconds=round(job.seconds or 0.0, 4),
                         queue_seconds=round(job.queue_seconds or 0.0, 4)
                         if job.queue_seconds is not None else None,
                         cache_hit=job.cache_hit,
                         read_cache=job.read_cache,
                         coalesced_with=job.coalesced_with,
                         error=job.error)

    # -- client API --------------------------------------------------------

    def job(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def wait(self, job: "Job | str",
             timeout: Optional[float] = None) -> Job:
        """Block until the job reaches a terminal state (returns it
        either way; raises TimeoutError past the deadline)."""
        import time
        j = job if isinstance(job, Job) else self.job(job)
        if j is None:
            raise KeyError(f"unknown job {job!r}")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done_cond:
            while j.state not in TERMINAL:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"job {j.id} still {j.state} after {timeout}s")
                self._done_cond.wait(remaining)
        return j

    def stats(self) -> Dict[str, Any]:
        """The serve bench's scoreboard: request counts by status,
        end-to-end p50/p99 of completed jobs, and the compiled-program
        cache's hit/miss view."""
        with self._lock:
            lat: List[float] = list(self._latencies)
            out = {
                "requests": self._submitted,
                "done": self._counts[DONE],
                "failed": self._counts[FAILED],
                "rejected": self._counts[REJECTED],
                "active": len(self._active),
                "queued": len(self._queue),
                "workers": self.workers,
                "computed": self._computed,
                "coalesced": self._coalesced,
                "shed": self._shed,
                "serve_backlog": self.serve_backlog,
                "deadline_expired": self._deadline_expired,
                "cancelled": self._cancelled,
                "released": self._released,
            }
        out["p50_s"] = round(percentile(lat, 50), 4)
        out["p99_s"] = round(percentile(lat, 99), 4)
        out["cache"] = _cache.cache_stats()
        out["read_cache"] = (self.read_cache.stats()
                             if self.read_cache is not None else None)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Live queue view — the SIGUSR1 postmortem's context card entry
        and the daemon's result-channel status."""
        with self._lock:
            active = [j.to_wire() for j in self._active.values()]
            recent = [j.to_wire() for j in
                      list(self._jobs.values())[-8:]
                      if j.state in TERMINAL]
        snap = self._queue.snapshot()
        snap.update({"active_jobs": active, "recent": recent,
                     "counts": dict(self._counts)})
        return snap

    def heartbeat(self) -> Dict[str, Any]:
        """One cheap liveness read (the StreamingProfiler.heartbeat
        idiom): emitted as a ``serve_heartbeat`` event when a sink is
        configured, and stamped onto the flight-recorder context."""
        st = self.stats()
        hb = {k: st[k] for k in ("requests", "done", "failed",
                                 "rejected", "active", "queued")}
        _obs_events.emit("serve_heartbeat", **hb)
        blackbox.set_context(last_serve_heartbeat=hb)
        return hb

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop admitting; drain queued jobs (workers exit once the
        queue empties); idempotent."""
        self._closed = True
        self._queue.close()
        if wait:
            for t in self._threads:
                t.join(timeout)
        blackbox.unregister_context_provider(self._context_provider)

    def __enter__(self) -> "ProfileScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
