"""Profile-as-a-service of the port: one resident process per host holds
the card, the warm runners and the loaded kernel libraries, so the process
start, the ``torch`` import, the CUDA context and the nvcc builds are paid
once and repeat profiles answer warm.

Counterpart of ``tpuprof/serve`` without its HTTP edge, breaker and drift
watch (a later slice):

* serve/cache.py      keyed runner cache (the fields that decide what a
                      runner launches) + the read tier's ResultCache
                      (answers keyed by source/config fingerprints,
                      CRC-checked, LRU-bounded)
* serve/jobs.py       job state machine + bounded multi-tenant queue
* serve/scheduler.py  worker pool, SLO metrics, job lifecycle, per-job
                      watchdog (job_timeout_s)
* serve/server.py     spool-directory daemon + submit client transport,
                      plus the fleet claim path (N daemons, one spool:
                      atomic job claims, heartbeats, stale-claim steal)

The store of built kernel libraries that makes a restart warm is
``runtime/aot.py``.  The CLI (``python -m tpuprof_torch serve`` /
``submit``) is one client of this package; embed
:class:`ProfileScheduler` directly for in-process use.
"""

from tpuprof_torch.serve.cache import (ResultCache, RunnerCache,
                                       acquire_runner, cache_stats,
                                       canonical_body, etag_for,
                                       process_cache, runner_key,
                                       source_fingerprint)
from tpuprof_torch.serve.jobs import (BacklogFull, Job, JobQueue,
                                      QueueClosed, QueueFull,
                                      TenantQuotaExceeded)
from tpuprof_torch.serve.scheduler import ProfileScheduler
from tpuprof_torch.serve.server import (JOB_SCHEMA, RESULT_SCHEMA,
                                        ServeDaemon, poll_intervals,
                                        read_result, wait_result, write_job)

__all__ = [
    "BacklogFull", "JOB_SCHEMA", "Job", "JobQueue", "ProfileScheduler",
    "QueueClosed", "QueueFull", "RESULT_SCHEMA", "ResultCache",
    "RunnerCache", "ServeDaemon", "TenantQuotaExceeded", "acquire_runner",
    "cache_stats", "canonical_body", "etag_for", "poll_intervals",
    "process_cache", "read_result", "runner_key", "source_fingerprint",
    "wait_result", "write_job",
]
